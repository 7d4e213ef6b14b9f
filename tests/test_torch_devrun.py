"""The device plane (``devices:D``) as a whole: ranks of a gloo group on the
CPU against the port's in-process ``shards:D`` trainer and the LIVE JAX
reference trainer.

Reduced llama3.2-1b, fastpath "on" (the plane's plain kernel versions),
lr 0.3, batch 4, seq 32, one torch thread a rank.  A world of 2 ranks runs
lag-wk (then one all-quiet round: the history raised by 1e9), laq@4 (with
a checkpoint at step 2, resumed), lasg-wk and num-lag-wk (the reference's
draws injected), 3 rounds each, and the launcher on ``devices:2``; a world
of 4 runs cyc-laq@8.  Each world is spawned once for the module
(``devrun.launch``, 120 s), while the parent runs the references.  Held:
masks, θ, the mirror state and the counters bitwise ``shards:D``'s (the
same ``run_case`` in one process); masks equal to the reference trainer's
and losses within its trainer-parity rtol 1e-4; every round's counted
collective bytes exactly the wire format's prediction, and an all-quiet
round's the mask and the losses alone; a resumed run bitwise the
uninterrupted one, its checkpoint the ``shards:2`` file's; the refusals
by name.
"""
import concurrent.futures
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import TokenStream as JTokenStream
from repro.data import make_inputs as jmake_inputs
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import make_train_step as jmake_train_step

import devrun_ranks as ranks
from repro_torch import devrun
from repro_torch.dist import collectives
from repro_torch.engine import Experiment, make_topology
from repro_torch.models import model

TIMEOUT = 120.0
STEPS = 3
WORLD2 = [("lag-wk", STEPS, "quiet"), ("laq@4", STEPS, "ckpt"),
          ("lasg-wk", STEPS, None), ("num-lag-wk", STEPS, None)]
WORLD4 = [("cyc-laq@8", STEPS, None)]
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_params():
    st = jinit_state(jax.random.PRNGKey(0), jget_config("llama3.2-1b")
                     .reduced(), JTrainerConfig(algo="gd", num_workers=2))
    return jax.tree_util.tree_map(np.asarray, st["params"])


def reference_draws(W, steps=STEPS + 1):
    """The reference trainer's num- schedule draws (schedule seed 0)."""
    return [int(jax.random.choice(jax.random.fold_in(
        jax.random.PRNGKey(0), k), W)) for k in range(steps)]


@pytest.fixture(scope="module")
def worlds(ref_params, tmp_path_factory):
    """Both worlds, started at once in the background: {W: (future, the
    checkpoint directory)}."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    out = {}
    for W, cases in ((2, WORLD2), (4, WORLD4)):
        ckpt = str(tmp_path_factory.mktemp(f"devices{W}"))
        out[W] = (pool.submit(
            devrun.launch, ranks.world, W, backend="gloo",
            args=(W, cases, ref_params, reference_draws(W), ckpt, W == 2),
            device="cpu", threads=1, timeout=TIMEOUT), ckpt)
    yield out
    pool.shutdown(wait=True)


def world_result(worlds, W):
    return worlds[W][0].result(timeout=TIMEOUT + 30)


def reference_run(ref_params, algo, W, steps=STEPS):
    """(masks, losses) of the reference trainer (fastpath "on")."""
    jcfg = jget_config("llama3.2-1b").reduced()
    jt = JTrainerConfig(algo=algo, num_workers=W, lr=ranks.LR, xi=ranks.XI,
                        fastpath="on")
    st = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    st = dict(st, params=jax.tree_util.tree_map(jax.numpy.asarray,
                                                ref_params))
    step = jax.jit(jmake_train_step(jcfg, jt))
    stream = JTokenStream(jcfg.vocab_size)
    masks, losses = [], []
    for k in range(steps):
        st, m = step(st, jmake_inputs(jcfg, stream, k, ranks.BATCH,
                                      ranks.SEQ))
        masks.append(np.asarray(m["comm_mask"]).tolist())
        losses.append(float(m["loss"]))
    return masks, losses


def same(a, b) -> bool:
    return np.array_equal(a, b)


def check_against_shards(got, want, rank, policy_keys):
    assert got["masks"] == want["masks"]
    assert got["losses"] == want["losses"]
    fin, wfin = got["final"], want["final"]
    assert same(fin["theta"], wfin["theta"])
    assert same(fin["nabla"], wfin["nabla"])
    for k in policy_keys:
        assert same(fin[k], wfin[k][rank:rank + 1]), k
    assert same(fin["comm_per_worker"], wfin["comm_per_worker"])
    assert fin["comm_total"] == wfin["comm_total"]


def check_bytes(got, algo, W):
    """Every round's counted bytes: the prediction exactly where some
    worker fired, the mask and the losses alone where none did."""
    policy = ranks.policy_for(ranks.TrainerConfig(
        algo=algo, num_workers=W, lr=ranks.LR), list(range(W)) * 8)
    params = model.templates(ranks.config())
    pred = devrun.predicted_collective_bytes(policy, params, W)
    for mask, recs in zip(got["masks"], got["records"]):
        acct = devrun.check_wire_accounting(recs, policy, params, W)
        if any(mask):
            assert acct["measured_total_bytes"] == pred["total"]
            assert acct["gather_rel_err"] == 0.0
        else:
            assert acct["measured_total_bytes"] \
                == pred["mask_bytes"] + pred["loss_bytes"]
        assert {r["what"] for r in recs} >= {"mask", "loss"}
        assert all(r["staged_bytes"] == 0 for r in recs)   # CPU tensors


@pytest.mark.parametrize("algo", [c[0] for c in WORLD2 + WORLD4])
def test_devices_bitwise_shards_and_masks_the_reference(worlds, ref_params,
                                                        algo, tmp_path):
    W = 4 if algo in {c[0] for c in WORLD4} else 2
    cases = dict((c[0], c) for c in WORLD2 + WORLD4)
    _, steps, extra = cases[algo]
    draws = reference_draws(W)
    want = ranks.run_case(algo, steps, W, ref_params, draws=draws,
                          quiet=extra == "quiet", devices=False,
                          ckpt_dir=str(tmp_path)
                          if extra == "ckpt" else None)
    jmasks, jlosses = reference_run(ref_params, algo, W)
    assert want["masks"] == jmasks
    np.testing.assert_allclose(want["losses"], jlosses, rtol=LOSS_RTOL)
    keys = ranks.policy_for(ranks.TrainerConfig(algo=algo, num_workers=W),
                            draws).state_keys
    results = world_result(worlds, W)
    assert len({r["pid"] for r in results}) == W
    for rank, res in enumerate(results):
        got = res[algo]
        check_against_shards(got, want, rank, keys)
        check_bytes(got, algo, W)
        if algo.startswith("num-"):
            assert got["masks"] == [[i == draws[k] for i in range(W)]
                                    for k in range(steps)]
        if algo.startswith("cyc-"):
            assert got["masks"] == [[i == k % W for i in range(W)]
                                    for k in range(steps)]
    if extra == "quiet":
        for rank, res in enumerate(results):
            q, wq = res[algo]["quiet"], want["quiet"]
            assert not any(q["mask"]) and q["mask"] == wq["mask"]
            assert q["loss"] == wq["loss"]
            assert same(q["theta"], wq["theta"])
            assert same(q["grad_hat"], res[algo]["final"]["grad_hat"])
            assert {r["what"] for r in q["records"]} == {"mask", "loss"}
            stats = collectives.collective_bytes(q["records"], W)
            assert stats.total_bytes == (W - 1) + 4.0 * (W - 1)


def test_devices_checkpoint_resumes_bitwise_and_is_the_shards_file(worlds,
                                                                   ref_params,
                                                                   tmp_path):
    from repro_torch.checkpoint import latest_step
    results = world_result(worlds, 2)
    for res in results:
        fin, again = res["laq@4"]["final"], res["laq@4"]["resumed"]
        for k in fin:
            assert same(fin[k], again[k]), k
    ckpt = worlds[2][1]
    assert latest_step(ckpt) == 2
    ranks.run_case("laq@4", 2, 2, ref_params, ckpt_dir=str(tmp_path),
                   devices=False)
    with np.load(f"{ckpt}/step_2.npz") as a, \
            np.load(f"{tmp_path}/step_2.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(bytes(a["__manifest__"]).decode()) \
            == json.loads(bytes(b["__manifest__"]).decode())
        for k in a.files:
            assert a[k].dtype == b[k].dtype and same(a[k], b[k]), k


def test_launcher_devices_prints_the_shards_masks(worlds, capsys):
    from repro_torch.launch import train
    lines = world_result(worlds, 2)[0]["launcher"]
    train.main(ranks.LAUNCH_ARGV + ["--topology", "shards:2"])
    want = capsys.readouterr().out.splitlines()
    pick = lambda ls: [ln.split(" | ")[:3] for ln in ls
                       if ln.startswith("step ")]
    assert len(pick(lines)) == 3 and pick(lines) == pick(want)
    assert [ln for ln in lines if ln.startswith("done:")]
    # rank 1 printed nothing: rank 0's lines are the run's only lines
    assert world_result(worlds, 2)[1]["launcher"] == []


def test_experiment_devices_is_its_shards_run(worlds):
    """``Experiment(topology="devices:2")`` inside the group: the report of
    ``topology="shards:2"`` in one process, losses and masks bitwise."""
    losses, mask, bpu, name = world_result(worlds, 2)[0]["experiment"]
    want = Experiment(topology="shards:2", **ranks.EXPERIMENT).run()
    assert name == "devices" and bpu == want.bytes_per_upload
    assert np.array_equal(losses, want.losses)
    assert np.array_equal(mask, want.comm_mask)


def test_refusals_by_name(worlds):
    res = world_result(worlds, 2)[0]
    assert res["world"].startswith("ValueError: devices:4 needs a world of "
                                   "4 ranks") and "fallback" in res["world"]
    assert res["bf16"].startswith("NotImplementedError: the devices "
                                  "topology on a bfloat16 or float16")
    # nccl with two ranks on one card (none here), before NCCL's own error
    with pytest.raises(ValueError, match="nccl needs one card per rank"):
        devrun.check_backend("nccl", 2, "cuda")
    with pytest.raises(ValueError, match="nccl needs one card per rank"):
        devrun.launch(ranks.world, 2, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="runs on CUDA devices"):
        devrun.check_backend("nccl", 1, "cpu")
    # outside a group: the builders and the front door name the launcher
    cfg = ranks.config()
    tcfg = ranks.TrainerConfig(algo="lag-wk", num_workers=2)
    with pytest.raises(RuntimeError, match="repro_torch.launch.train"):
        devrun.make_device_step(cfg, tcfg, topology=make_topology(
            "devices:2"))
    with pytest.raises(RuntimeError, match="repro_torch.launch.train"):
        Experiment(model=cfg, topology="devices:2", steps=1, workers=2,
                   batch=4, seq=16, device="cpu").run()
    with pytest.raises(ValueError, match="DeviceWorkers"):
        devrun.make_device_step(cfg, tcfg, topology=make_topology("shards"))


def test_mesh_builders_describe_without_devices():
    from repro_torch.launch import mesh
    prod = mesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert mesh.data_axes(prod) == ("data",) and mesh.batch_shards(prod) == 16
    multi = mesh.make_production_mesh(multi_pod=True)
    assert mesh.data_axes(multi) == ("pod", "data")
    assert mesh.batch_shards(multi) == 32
    topo = make_topology("devices:3")
    assert topo.num_devices() == 3 and not topo.available()
