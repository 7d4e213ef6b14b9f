"""bfloat16 checkpoints in the reference's format, and the launcher's GD
baseline after a resume.

  * the port's npz entry for a bfloat16 tensor is byte-equal to the
    reference's ``save`` of the same values (descr ``'<V2'``, read back by
    numpy as ``|V2``; manifest dtype ``"bfloat16"``), and a tree of both
    dtypes (``Parts``) names its parts ``.b`` / ``.f``;
  * a checkpoint the reference wrote restores through the port's reader
    bit for bit (the reference's own restore of it raises, ROADMAP queue
    3);
  * a bfloat16 trainer state, a ``Parts`` state and a fleet state
    round-trip bitwise and in place;
  * a 4-round bfloat16 run on shards, pods:2, async:2@1 and fleet:4@2 (the
    all-bfloat16 llama; async also mamba2's mixed tree) equals 2 rounds +
    save + a fresh init + restore + 2 rounds, bit for bit;
  * the launcher's closing "uploads N vs GD M (x% of GD)" after
    ``--resume`` is the reference launcher's on the same reduced run.
"""
import json
import re
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.launch import train as jlaunch_train

from repro_torch import fleet
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_flatten
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.engine import make_topology
from repro_torch.fastpath.layout import Parts
from repro_torch.launch import train as launch_train

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
BATCH, SEQ = 4, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t) \
        .numpy().tobytes()


def same_bits(a, b):
    """Two trees of one structure with bitwise-equal leaves (bfloat16
    tensors compared as their raw words)."""
    la, da = tree_flatten(a)
    lb, db = tree_flatten(b)
    assert da == db
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype \
                and x.shape == y.shape and bits(x) == bits(y)
        else:
            assert type(x) is type(y) and x == y
    return True


def bf16_tensor(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def as_jax(t: torch.Tensor):
    return jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))


def manifest(path):
    with np.load(path) as z:
        return json.loads(bytes(z["__manifest__"]).decode())


# ---------------------------------------------------------------------------
# The format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (7,), (3, 129), (2, 8, 128)])
def test_bf16_entry_is_the_references_bytes(tmp_path, shape):
    x = bf16_tensor(shape, 1)
    p = save(str(tmp_path / "port"), 0, {"w": x, "f": torch.ones(3)})
    q = jstore.save(str(tmp_path / "ref"), 0, {"w": as_jax(x),
                                               "f": jnp.ones(3)})
    assert manifest(p) == manifest(q)
    assert manifest(p)[1] == {"key": "a1", "path": "['w']",
                              "dtype": "bfloat16"}
    with zipfile.ZipFile(p) as zp, zipfile.ZipFile(q) as zq:
        assert zp.namelist() == zq.namelist()
        for name in zp.namelist():
            assert zp.read(name) == zq.read(name), name
    with np.load(p) as z:
        assert z["a1"].dtype == np.dtype("V2") and z["a1"].shape == shape


def test_parts_leaves_are_named_by_field(tmp_path):
    """A ``Parts`` pair is a node of two leaves, ``.b`` and ``.f``, as
    JAX's ``keystr`` names a NamedTuple's fields."""
    st = {"theta": Parts(bf16_tensor((8, 128), 2), torch.randn(8, 128))}
    m = manifest(save(str(tmp_path), 3, st))
    assert [(e["path"], e["dtype"]) for e in m] == [
        ("['theta'].b", "bfloat16"), ("['theta'].f", "float32")]
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(
                  {"theta": Parts(1, 2)})[0]]
    assert jpaths == [e["path"] for e in m]


def test_reference_checkpoint_restores_bitwise(tmp_path):
    """The reference writes a bfloat16 leaf that its own ``restore``
    cannot cast back (queue 3); the port's reader restores it bit for
    bit, in place."""
    x, y = bf16_tensor((5, 33), 3), torch.randn(4)
    jstore.save(str(tmp_path), 2, {"p": {"w": as_jax(x)}, "y": jnp.asarray(
        y.numpy()), "step": 2})
    with pytest.raises(ValueError, match="No cast function"):
        jstore.restore(str(tmp_path), {"p": {"w": as_jax(x)},
                                       "y": jnp.zeros(4), "step": 0})
    like = {"p": {"w": torch.zeros(5, 33, dtype=torch.bfloat16)},
            "y": torch.zeros(4), "step": 0}
    w = like["p"]["w"]
    out, step = restore(str(tmp_path), like)
    assert step == 2 and out["p"]["w"] is w
    same_bits(out, {"p": {"w": x}, "y": y, "step": 2})


def run(cfg, tcfg, topology, state, step_fn, k0, k1):
    stream = TokenStream(cfg.vocab_size)
    out = []
    for k in range(k0, k1):
        state, m = step_fn(state, make_inputs(cfg, stream, k, BATCH, SEQ,
                                              device="cpu"))
        out.append((float(m["loss"]), m["comm_mask"].tolist()))
    return state, out


def fresh(cfg, tcfg, spec, seed=0):
    topo = make_topology(spec)
    if spec.startswith("fleet"):
        return (fleet.init_fleet_state(cfg, tcfg, topo, device="cpu",
                                       seed=seed),
                fleet.make_fleet_step(cfg, tcfg, topo))
    return (init_state(cfg, tcfg, device="cpu", seed=seed, topology=topo),
            make_train_step(cfg, tcfg, topology=topo))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-370m"])
def test_bf16_states_round_trip_in_place(tmp_path, arch):
    """Trainer (async: θ, the ring, ĝ, θ̂ at bfloat16 or in parts), and
    fleet states (float32 compact rows) after a round: saved, restored
    into a fresh init (other weights), bitwise, every tensor in place."""
    cfg = get_config(arch).reduced(**BF16)
    tcfg = TrainerConfig(algo="lag-ps", num_workers=2, lr=0.3)
    for spec in ("async:2@1", "fleet:4@2"):
        st, step = fresh(cfg, tcfg, spec)
        st, _ = run(cfg, tcfg, spec, st, step, 0, 1)
        save(str(tmp_path / spec), st["step"], st)
        like, _ = fresh(cfg, tcfg, spec, seed=5)
        before, _ = tree_flatten(like)
        out, k = restore(str(tmp_path / spec), like)
        after, _ = tree_flatten(out)
        assert k == 1 and same_bits(out, st)
        assert all(a is b for a, b in zip(before, after)
                   if isinstance(a, torch.Tensor))
        if arch == "mamba2-370m" and spec.startswith("async"):
            assert isinstance(out["lag"]["theta_ring"], Parts)


RESUME = [("llama3.2-1b", "shards", "lag-wk"),
          ("llama3.2-1b", "pods:2", "lag-ps"),
          ("llama3.2-1b", "async:2@1", "laq@4"),
          ("llama3.2-1b", "fleet:4@2", "lag-wk"),
          ("mamba2-370m", "async:2@1", "lag-wk")]


@pytest.mark.parametrize("arch, spec, algo", RESUME)
def test_resumed_bf16_run_is_bitwise_the_uninterrupted_run(tmp_path, arch,
                                                           spec, algo):
    cfg = get_config(arch).reduced(**BF16)
    tcfg = TrainerConfig(algo=algo, num_workers=2, lr=0.3, fastpath="on")
    st, step = fresh(cfg, tcfg, spec)
    whole, rounds = run(cfg, tcfg, spec, st, step, 0, 4)
    st, step = fresh(cfg, tcfg, spec)
    st, first = run(cfg, tcfg, spec, st, step, 0, 2)
    save(str(tmp_path), 2, st)
    del st
    st, step = fresh(cfg, tcfg, spec, seed=7)      # other weights
    st, k = restore(str(tmp_path), st)
    st, second = run(cfg, tcfg, spec, st, step, 2, 4)
    assert k == 2 and first + second == rounds
    same_bits(st, whole)


# ---------------------------------------------------------------------------
# The launcher's GD baseline after --resume
# ---------------------------------------------------------------------------

GD_LINE = re.compile(r"uploads (\d+) vs GD (\d+) \(([\d.]+)% of GD\)")


def closing_figure(out: str):
    return GD_LINE.findall(out)[-1]


def test_resumed_launcher_prints_the_references_gd_baseline(tmp_path,
                                                             capsys):
    """Both launchers, 2 rounds with ``--ckpt-every 2``, then ``--resume``
    to round 4: the closing "uploads N vs GD M (x% of GD)" is the same —
    GD over the resumed rounds only, uploads counted since round 0."""
    base = ["--reduced", "--workers", "2", "--batch", "4", "--seq", "16",
            "--algo", "lag-wk"]
    got, want = [], []
    for pkg, extra, into in ((launch_train, ["--device", "cpu",
                                             "--fastpath", "on"], got),
                             (jlaunch_train, [], want)):
        ck = str(tmp_path / pkg.__name__)
        pkg.main(base + extra + ["--steps", "2", "--ckpt-dir", ck,
                                 "--ckpt-every", "2"])
        into.append(closing_figure(capsys.readouterr().out))
        pkg.main(base + extra + ["--steps", "4", "--ckpt-dir", ck,
                                 "--resume"])
        out = capsys.readouterr().out
        assert "resumed from step 2" in out
        into.append(closing_figure(out))
    assert got == want
    assert got[1][1] == "4"          # 2 resumed rounds × 2 workers
