"""The port's checkpoints (``repro_torch.checkpoint``), its JSONL logger
(``repro_torch.metrics``) and the launcher's ``--ckpt-dir`` /
``--ckpt-every`` / ``--resume`` / ``--log``.

  * a save / restore round trip is bitwise, in place (the restored tensors
    are ``like``'s own), for every dtype the trainer states hold;
  * the file format is the reference's: ``repro.checkpoint.restore`` reads
    a port checkpoint and the port reads a reference checkpoint;
  * a path or shape mismatch raises;
  * a run resumed at round 2 of 4 is bitwise the uninterrupted one —
    rounds 3 and 4's losses and masks and the whole final state — on every
    topology the launcher runs (shards, pods:2, async:2@1, fleet:8@4 with
    churn and lazy selection, graph:4@ring), with a sampled schedule,
    LAQ's residual and a stateful server among them;
  * ``--log`` writes one JSON line per logged round (every 10th, the last).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint

from repro_torch import metrics
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.launch import train as launch_train


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_bits(a, b):
    """Two trees with the same structure and bitwise-equal leaves."""
    la, da = tree_flatten(a)
    lb, db = tree_flatten(b)
    if da != db:
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and
                    x.numpy().tobytes() == y.numpy().tobytes()):
                return False
        elif type(x) is not type(y) or x != y:
            return False
    return True


def sample_state():
    g = torch.Generator().manual_seed(3)
    return {
        "theta": torch.randn((2, 8, 128), generator=g),
        "lag": {"grad_hat": torch.randn((3, 8, 128), generator=g),
                "hist": torch.rand((10,), generator=g),
                "nabla64": torch.randn((4,), generator=g,
                                       dtype=torch.float64),
                "comm_total": torch.tensor(17, dtype=torch.int32),
                "fleet_alive": torch.tensor([True, False, True])},
        "opt": {"mu": torch.randn((8, 128), generator=g)},
        "step": 12,
    }


def zeros_like_state(st):
    leaves, treedef = tree_flatten(st)
    return tree_unflatten(treedef, [torch.zeros_like(x)
                                    if isinstance(x, torch.Tensor) else 0
                                    for x in leaves])


def test_round_trip_is_bitwise_and_in_place(tmp_path):
    st = sample_state()
    path = save(str(tmp_path), 12, st)
    assert os.path.basename(path) == "step_12.npz"
    assert sorted(os.listdir(tmp_path)) == ["step_12.npz"]   # no temp left
    assert latest_step(str(tmp_path)) == 12
    like = zeros_like_state(st)
    got, step = restore(str(tmp_path), like)
    assert step == 12 and same_bits(got, st)
    # in place: the restored tensors are like's own buffers
    assert got["theta"] is like["theta"]
    assert got["lag"]["grad_hat"] is like["lag"]["grad_hat"]
    assert got["step"] == 12 and isinstance(got["step"], int)
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
    paths = [m["path"] for m in manifest]
    assert "['lag']['grad_hat']" in paths and "['step']" in paths
    assert {m["path"]: m["dtype"] for m in manifest}[
        "['lag']['nabla64']"] == "float64"


def test_latest_step_and_empty_dirs(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        restore(str(tmp_path), sample_state())
    st = sample_state()
    for s in (2, 10, 4):
        save(str(tmp_path), s, st)
    assert latest_step(str(tmp_path)) == 10
    _, step = restore(str(tmp_path), zeros_like_state(st), step=4)
    assert step == 4


def test_the_format_is_the_references(tmp_path):
    """A port checkpoint restores through the reference's reader and a
    reference checkpoint through the port's, value for value."""
    st = sample_state()
    save(str(tmp_path / "port"), 3, st)
    like = {"theta": np.zeros((2, 8, 128), np.float32),
            "lag": {"grad_hat": np.zeros((3, 8, 128), np.float32),
                    "hist": np.zeros((10,), np.float32),
                    "nabla64": np.zeros((4,), np.float64),
                    "comm_total": np.zeros((), np.int32),
                    "fleet_alive": np.zeros((3,), bool)},
            "opt": {"mu": np.zeros((8, 128), np.float32)},
            "step": np.zeros((), np.int64)}
    got, step = jcheckpoint.restore(str(tmp_path / "port"), like)
    assert step == 3
    assert np.array_equal(got["theta"], st["theta"].numpy())
    assert np.array_equal(got["lag"]["nabla64"], st["lag"]["nabla64"].numpy())
    assert int(got["step"]) == 12
    ref_tree = {"theta": jnp.asarray(st["theta"].numpy()),
                "lag": {"hist": jnp.asarray(st["lag"]["hist"].numpy())},
                "step": jnp.asarray(5, jnp.int32)}
    jcheckpoint.save(str(tmp_path / "ref"), 7, ref_tree)
    back, step = restore(str(tmp_path / "ref"), {
        "theta": torch.zeros((2, 8, 128)),
        "lag": {"hist": torch.zeros((10,))},
        "step": 0})
    assert step == 7 and back["step"] == 5
    assert torch.equal(back["theta"], st["theta"])
    assert torch.equal(back["lag"]["hist"], st["lag"]["hist"])


@pytest.mark.parametrize("change, err, match", [
    (lambda s: s["lag"].update(extra=torch.zeros(2)), KeyError,
     r"missing leaf \['lag'\]\['extra'\]"),
    (lambda s: s["lag"].pop("hist"), KeyError,
     r"\['lag'\]\['hist'\] is not in the state"),
    (lambda s: s.update(theta=torch.zeros((2, 8, 64))), ValueError,
     r"shape mismatch at \['theta'\]"),
])
def test_path_and_shape_mismatches_raise(tmp_path, change, err, match):
    save(str(tmp_path), 1, sample_state())
    like = zeros_like_state(sample_state())
    change(like)
    with pytest.raises(err, match=match):
        restore(str(tmp_path), like)


# ---------------------------------------------------------------------------
# The launcher: resume is exact, the log is one line per logged round
# ---------------------------------------------------------------------------

def run_cli(extra, steps):
    """The launcher on the CPU (reduced model, the plane forced); returns
    ({round: (loss, mask)}, final state)."""
    rounds = {}
    state = launch_train.main(
        ["--reduced", "--device", "cpu", "--workers", "2", "--batch", "8",
         "--seq", "16", "--lr", "0.3", "--fastpath", "on", "--steps",
         str(steps)] + list(extra),
        on_step=lambda k, m, t: rounds.update(
            {k: (float(m["loss"]), m["comm_mask"].tolist())}))
    return rounds, state


RESUME_CASES = [
    ("shards", "lag-wk", ()),
    ("shards", "num-iag", ()),
    ("pods:2", "lag-wk", ()),
    ("async:2@1", "lag-ps", ()),
    ("fleet:8@4", "lag-wk", ("--fleet-churn", "0.25", "--fleet-selection",
                             "innovation")),
    ("graph:4@ring", "lag-wk", ()),
    ("graph:4@ring", "laq@4", ("--server", "momentum@0.9")),
]


@pytest.mark.parametrize("topology, algo, extra", RESUME_CASES,
                         ids=lambda x: x if isinstance(x, str) else "-")
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, capsys, topology,
                                                 algo, extra):
    flags = ["--topology", topology, "--algo", algo, *extra]
    whole_rounds, whole = run_cli(flags, 4)
    ck = str(tmp_path / "ck")
    first_rounds, _ = run_cli(flags + ["--ckpt-dir", ck, "--ckpt-every",
                                       "2"], 2)
    assert latest_step(ck) == 2 and first_rounds == {
        k: whole_rounds[k] for k in (0, 1)}
    resumed_rounds, resumed = run_cli(flags + ["--ckpt-dir", ck,
                                               "--resume"], 4)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed_rounds == {k: whole_rounds[k] for k in (2, 3)}
    assert resumed["step"] == whole["step"] == 4
    assert same_bits(resumed, whole)


def test_log_writes_one_line_per_logged_round(tmp_path, capsys):
    path = tmp_path / "logs" / "run.jsonl"
    rounds, _ = run_cli(["--log", str(path)], 12)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 10, 11]
    for r in lines:
        assert set(r) == {"step", "t", "loss", "comm_round", "comm_total"}
        assert r["loss"] == pytest.approx(rounds[r["step"]][0], rel=1e-7)
        assert r["comm_round"] == sum(rounds[r["step"]][1])
    assert lines[-1]["comm_total"] == sum(sum(m) for _, m in rounds.values())
    # the echo goes to stderr, one k=v line per logged round
    assert capsys.readouterr().err.count("comm_total=") == 3


def test_logger_serves_zero_d_tensors(tmp_path):
    log = metrics.Logger(str(tmp_path / "m.jsonl"), echo=False)
    log.log(3, loss=torch.tensor(1.5), n=torch.tensor(4, dtype=torch.int32),
            tag="x")
    log.close()
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec["loss"] == 1.5 and rec["n"] == 4.0 and rec["tag"] == "x"
