"""The row-sharded trainer (``--mesh host`` on N ranks,
``repro_torch.dist.row_shards``): ranks of a gloo group on the CPU against
the port's one-process ``shards:W`` trainer and the LIVE JAX reference
trainer.

The config is the reference's own sharded-trainer test's
(``tests/test_dist.py``: the reduced llama3.2-1b, W = 4, lr 0.05, the
heterogeneous batch of round 0, 3 rounds), fastpath "on", one torch thread
a rank.  A world of 2 and one of 4 ranks run lag-wk, lag-ps, laq@4 (with a
checkpoint at round 2, restored into a fresh state and run on), lasg-wk and
adam; the world of 2 also a bfloat16 lag-wk, the DTensor placements, the
refusals and the launcher's ``--ranks 2``; a world of 3 runs lag-wk at W =
3 (the reduced llama's 41 blocks of rows do not divide by 3: the last
rank's rows end in padding).  Each world is spawned once for the module
(``devrun.launch``) while the parent runs the one-process trainer and the
reference.  Held: masks, losses, θ and every row-held buffer's rows
bitwise the ``shards:W`` run's, the padding zero, each rank's buffers 1/N
of the rows; losses within the reference test's rtol 2e-4 of the
reference's trainer, ``comm_total`` equal and the parameters within its
atol 2e-3; the counted collective bytes of every round the rules'
prediction; the checkpoint the ``shards:W`` file bit for bit, the resumed
run bitwise the uninterrupted one.
"""
import concurrent.futures
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import TokenStream as JTokenStream
from repro.data import make_heterogeneous_inputs as jhetero
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import make_train_step as jmake_train_step

import sharded_ranks as ranks
from repro_torch import devrun
from repro_torch.core.tree import tree_leaves
from repro_torch.dist import collectives, row_shards
from repro_torch.dist.lag_trainer import param_layout
from repro_torch.fastpath.layout import BLOCK_ROWS, RowShard
from repro_torch.launch import mesh as mesh_lib

TIMEOUT = 240.0
LOSS_RTOL, PARAM_ATOL = 2e-4, 2e-3        # tests/test_dist.py's
# adam: Adam moves a coordinate by about lr·sign(mean gradient) whatever
# the gradient's size, so where the two packages' aggregates sit near zero
# a few-ulp difference between their matmuls changes that coordinate's
# step by up to 2·lr (a flipped sign): the reference test's atol (written
# for lag-wk) holds but for such coordinates, which are bounded as
# tests/test_torch_policies.py bounds them (a share of 2e-4 of the
# parameters, each within 2·lr a round)
ADAM_FLIP_SHARE, ADAM_MAX_DTHETA = 2e-4, 2 * ranks.LR * ranks.STEPS
WORLDS = ((2, True), (4, True), (3, False))


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


@pytest.fixture(scope="module")
def worlds(ref_params, tmp_path_factory):
    """Every world, started at once in the background: {N: (future, the
    checkpoint directory)}."""
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    out = {}
    for N, full in WORLDS:
        ckpt = str(tmp_path_factory.mktemp(f"mesh{N}"))
        out[N] = (pool.submit(devrun.launch, ranks.world, N, backend="gloo",
                              args=(N, ref_params, ckpt, full),
                              device="cpu", threads=1, timeout=TIMEOUT),
                  ckpt)
    yield out
    pool.shutdown(wait=True)


def world_result(worlds, N):
    return worlds[N][0].result(timeout=TIMEOUT + 30)


_SHARDS = {}


def shards_run(ref_params, algo, workers=ranks.W, dtype=None, ckpt=None):
    """The one-process shards:W run (cached for the module)."""
    key = (algo, workers, dtype, ckpt is not None)
    if key not in _SHARDS:
        _SHARDS[key] = ranks.run_case(algo, ref_params, workers=workers,
                                      dtype=dtype, ckpt_dir=ckpt)
    return _SHARDS[key]


def reference_run(ref_params, algo):
    """(losses, comm_total, params) of the reference's single-device
    trainer on the same config."""
    jcfg = jget_config("llama3.2-1b").reduced()
    jt = JTrainerConfig(algo=algo, num_workers=ranks.W, lr=ranks.LR)
    st = dict(jinit_state(jax.random.PRNGKey(0), jcfg, jt),
              params=jax.tree_util.tree_map(jax.numpy.asarray, ref_params))
    step = jax.jit(jmake_train_step(jcfg, jt))
    b = jhetero(jcfg, JTokenStream(vocab=jcfg.vocab_size, seed=0), 0,
                ranks.W, ranks.BATCH, ranks.SEQ)
    losses = []
    for _ in range(ranks.STEPS):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    return losses, int(m["comm_total"]), st["params"]


def check_rows(got, want, N, rank, rows):
    """Masks, losses, counters, θ bitwise; each row-held buffer this
    rank's rows of the one-process buffer, its padding zero."""
    sh = RowShard(rows, N, rank)
    assert got["masks"] == want["masks"]
    assert got["losses"] == want["losses"]
    assert got["metrics"] == want["metrics"]
    fin, wfin = got["final"], want["final"]
    for k in ("theta", "comm_per_worker", "comm_total", "hist"):
        assert np.array_equal(fin[k], wfin[k]), k
    for k, v in wfin.items():
        if k == "theta" or np.ndim(v) < 2:
            continue
        mine = fin[k]
        assert mine.shape[-2] == sh.shard_rows, k
        assert np.array_equal(mine[..., :sh.valid, :],
                              v[..., sh.start:sh.start + sh.valid, :]), k
        assert not mine[..., sh.valid:, :].any(), k


@pytest.mark.parametrize("N", [2, 4])
@pytest.mark.parametrize("algo", ranks.ALGOS)
def test_row_sharded_bitwise_shards_and_within_the_reference(
        worlds, ref_params, algo, N, tmp_path):
    want = shards_run(ref_params, algo)
    rows = param_layout(ranks.config()).rows
    results = world_result(worlds, N)
    assert len(results) == N
    for rank, res in enumerate(results):
        check_rows(res[algo], want, N, rank, rows)
    if N == 2:
        jl, jtotal, jparams = reference_run(ref_params, algo)
        np.testing.assert_allclose(want["losses"], jl, rtol=LOSS_RTOL)
        assert want["final"]["comm_total"] == jtotal
        lo = param_layout(ranks.config())
        ours = lo.unflatten(torch.from_numpy(want["final"]["theta"]))
        off, n = 0, 0
        for a, b in zip(jax.tree_util.tree_leaves(jparams),
                        tree_leaves(ours)):
            a, b = np.asarray(a), b.numpy()
            if algo != "adam":
                np.testing.assert_allclose(a, b, atol=PARAM_ATOL)
                continue
            off += int((np.abs(a - b) > PARAM_ATOL).sum())
            n += a.size
            assert np.all(np.abs(a - b) <= ADAM_MAX_DTHETA)
        assert off <= ADAM_FLIP_SHARE * n, (off, n)


def test_each_rank_holds_a_share_of_the_rows(worlds):
    """ĝ, θ̂, LAQ's residual and ∇ are (…, R, 128) with R the rank's share
    (a multiple of 256, N·R the rows padded); θ stays whole."""
    rows = param_layout(ranks.config()).rows
    for N in (2, 4):
        R = -(-rows // BLOCK_ROWS // N) * BLOCK_ROWS
        assert R * N >= rows > R * (N - 1)
        for res in world_result(worlds, N):
            for algo in ranks.ALGOS:
                shapes = {k: v[0] for k, v in res[algo]["shapes"].items()}
                assert shapes["theta"] == (R * N, 128)
                assert shapes["nabla"] == (R, 128)
                for k in ("grad_hat", "theta_hat", "resid"):
                    if k in shapes:
                        assert shapes[k] == (ranks.W, R, 128), (algo, k)


def test_unaligned_rows_over_three_ranks(worlds, ref_params):
    rows = param_layout(ranks.config()).rows
    assert (rows // BLOCK_ROWS) % 3                 # 41 blocks
    want = shards_run(ref_params, "lag-wk", workers=3)
    results = world_result(worlds, 3)
    assert RowShard(rows, 3, 2).valid < RowShard(rows, 3, 2).shard_rows
    for rank, res in enumerate(results):
        check_rows(res["lag-wk"], want, 3, rank, rows)


def test_bfloat16_row_sharded_bitwise_shards(worlds, ref_params):
    want = shards_run(ref_params, "lag-wk", dtype="bfloat16")
    rows = param_layout(ranks.config("bfloat16")).rows
    for rank, res in enumerate(world_result(worlds, 2)):
        got = res["bf16"]
        assert got["shapes"]["grad_hat"][1] == "torch.bfloat16"
        check_rows(got, want, 2, rank, rows)


@pytest.mark.parametrize("N", [2, 4])
def test_collective_bytes_are_the_rules_prediction(worlds, N):
    """Every round's records, kind by kind and byte for byte, those
    ``sharding.row_shard_records`` predicts; their ring bytes equal."""
    for res in world_result(worlds, N):
        for algo in ranks.ALGOS:
            pred = res["predicted"][algo]
            key = lambda r: (r["what"], r["kind"], r["bytes"])
            want = sorted(map(key, pred))
            for recs in res[algo]["records"]:
                assert sorted(map(key, recs)) == want, algo
                assert all(r["staged_bytes"] == 0 for r in recs)
                got = collectives.collective_bytes(recs)
                assert got.total_bytes == \
                    collectives.collective_bytes(pred).total_bytes


def test_checkpoint_is_the_shards_file_and_resumes_bitwise(worlds,
                                                           ref_params,
                                                           tmp_path):
    results = world_result(worlds, 2)
    for res in results:
        fin, again = res[ranks.CKPT_ALGO]["final"], \
            res[ranks.CKPT_ALGO]["resumed"]
        for k in fin:
            assert np.array_equal(fin[k], again[k]), k
    shards_run(ref_params, ranks.CKPT_ALGO, ckpt=str(tmp_path))
    ckpt = worlds[2][1]
    with np.load(f"{ckpt}/step_{ranks.CKPT_AT}.npz") as a, \
            np.load(f"{tmp_path}/step_{ranks.CKPT_AT}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(bytes(a["__manifest__"]).decode()) \
            == json.loads(bytes(b["__manifest__"]).decode())
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_dtensor_placements_hold_each_specs_shard(worlds):
    """``tree_shardings`` / ``batch_shardings`` on the 2-rank CPU mesh:
    every local shard has the spec's shape and the whole tensor's values
    there; the stacked norm scales take "data" (the generic rule)."""
    for rank, res in enumerate(world_result(worlds, 2)):
        sharded = 0
        for spec, shape, local, equal in res["placements"]:
            want = tuple(d // 2 if e == "data" else d
                         for d, e in zip(shape, spec))
            assert local == want and equal, (spec, shape, local)
            sharded += "data" in spec
        assert sharded > 0


def test_refusals_by_name(worlds):
    got = world_result(worlds, 2)[0]["refusals"]
    assert got["topology"].startswith("NotImplementedError: --mesh host at "
                                      "more than one rank runs --topology "
                                      "shards") and "item 9" in got["topology"]
    assert "legacy per-leaf route" in got["legacy"] and "item 10" in \
        got["legacy"]
    assert "Parts" in got["mixed"] and "item 11" in got["mixed"]
    assert got["workers"].startswith("ValueError: the host mesh's 2 data "
                                     "ranks must divide the 3 workers")
    assert got["plane"].startswith("ValueError: the row-sharded trainer "
                                   "runs lag-wk's trigger on the comm plane")
    # a model axis is tensor parallelism, refused before any group
    with pytest.raises(NotImplementedError, match="item 12"):
        row_shards.mesh_group(mesh_lib.make_production_mesh())


def test_launcher_ranks_prints_the_shards_run(worlds, capsys):
    from repro_torch.launch import train
    lines = world_result(worlds, 2)[0]["launcher"]
    train.main(ranks.LAUNCH_ARGV)
    want = capsys.readouterr().out.splitlines()
    pick = lambda ls: [ln.split(" | ")[:3] for ln in ls
                       if ln.startswith("step ")]
    assert len(pick(lines)) == 3 and pick(lines) == pick(want)
    assert [ln for ln in lines if ln.startswith("done:")]
    assert world_result(worlds, 2)[1]["launcher"] == []
    for bad, match in ((["--mesh", "prod"], "item 12"),
                       (["--mesh", "prod2"], "512 ranks"),
                       (["--ranks", "2", "--topology", "pods:2"], "item 9")):
        with pytest.raises(SystemExit, match=match):
            train.main(ranks.LAUNCH_ARGV + bad)
