"""The ranks of ``tests/test_torch_sharded_train.py``: functions that
``repro_torch.devrun.launch`` runs in spawned processes, one a rank of a
gloo group on the CPU holding the (N, 1) host mesh.  The module imports no
JAX (a spawned rank imports it to find its function), and both sides of a
parity check run the same ``run_case``: the row-sharded trainer here
(``mesh=``), the one-process ``shards:W`` trainer in the test (``mesh``
None).

The config is the reference's own sharded-trainer test's
(``tests/test_dist.py``): the reduced llama3.2-1b, W = 4, lr 0.05, the
heterogeneous batch of round 0 (batch 8, seq 64) every round, 3 rounds;
fastpath "on" (the plane's plain kernel versions on the CPU).
"""
import contextlib
import io

import torch

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream, make_heterogeneous_inputs
from repro_torch.dist import row_shards, sharding
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.weights import params_from_reference

W, LR, BATCH, SEQ, STEPS = 4, 0.05, 8, 64, 3
ALGOS = ("lag-wk", "lag-ps", "laq@4", "lasg-wk", "adam")
CKPT_ALGO, CKPT_AT = "laq@4", 2
LAUNCH_ARGV = ["--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
               "--workers", "4", "--device", "cpu", "--fastpath", "on"]


def config(dtype=None):
    cfg = get_config("llama3.2-1b").reduced()
    return cfg.replace(dtype=dtype, param_dtype=dtype) if dtype else cfg


def batch(cfg, workers=W, device="cpu"):
    return make_heterogeneous_inputs(cfg, TokenStream(vocab=cfg.vocab_size,
                                                      seed=0), 0, workers,
                                     BATCH, SEQ, device=device)


def run_case(algo, ref_params, mesh=None, workers=W, dtype=None,
             ckpt_dir=None, steps=STEPS, device="cpu"):
    """``steps`` rounds → masks, losses, θ (the layout's rows), every
    row-held lag buffer (this rank's rows, or all), the counters, each
    round's collective records and the buffers' shapes; with
    ``ckpt_dir``, a checkpoint at ``CKPT_AT`` and (``mesh``) the rounds
    after it again from a fresh state restored from that file.  On
    ``device`` (the CPU here, the card in the ``cuda`` tests)."""
    cfg = config(dtype)
    tcfg = TrainerConfig(algo=algo, num_workers=workers, lr=LR,
                         fastpath="on")
    params = params_from_reference(ref_params, cfg, device=device)
    rows = row_shards.lag_trainer.param_layout(cfg).rows

    def fresh():
        return (init_state(cfg, tcfg, device=device, params=params,
                           mesh=mesh),
                make_train_step(cfg, tcfg, mesh=mesh))

    def snapshot(state):
        lag = state["lag"]
        return {"theta": bits(state["theta"][:rows]),
                **{k: bits(v) for k, v in lag.items() if v.dim() >= 2},
                "comm_per_worker": bits(lag["comm_per_worker"]),
                "comm_total": int(lag["comm_total"]),
                "hist": bits(lag["hist"])}

    b = batch(cfg, workers, device)
    state, step = fresh()
    out = {"masks": [], "losses": [], "records": [], "metrics": []}
    for k in range(steps):
        state, m = step(state, b)
        out["masks"].append(m["comm_mask"].tolist())
        out["losses"].append(float(m["loss"]))
        out["records"].append(m.get("records"))
        out["metrics"].append({key: float(m[key]) for key in (
            "comm_this_round", "comm_total", "wire_bytes_total")})
        if ckpt_dir is not None and k + 1 == CKPT_AT:
            if mesh is not None:
                row_shards.save_checkpoint(ckpt_dir, CKPT_AT, state, cfg,
                                           mesh)
            else:
                from repro_torch.checkpoint import save
                save(ckpt_dir, CKPT_AT, state)
    out["final"] = snapshot(state)
    out["shapes"] = {k: (tuple(v.shape), str(v.dtype))
                     for k, v in state["lag"].items() if v.dim() >= 2}
    out["shapes"]["theta"] = (tuple(state["theta"].shape),
                              str(state["theta"].dtype))
    if ckpt_dir is not None and mesh is not None:
        again, step2 = fresh()
        again, at = row_shards.restore_checkpoint(ckpt_dir, again, cfg, mesh)
        for k in range(at, steps):
            again, _ = step2(again, b)
        out["resumed"] = snapshot(again)
    return out


def bits(t):
    """A tensor's values as numpy, a 2-byte float as its raw words (the
    results cross between processes as numpy)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)
    return t.numpy().copy()


def _refused(fn):
    try:
        fn()
    except (ValueError, NotImplementedError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def refusals(mesh):
    """What the row-sharded trainer refuses by name, on this rank's mesh."""
    from repro_torch.engine.topology import make_topology
    cfg = config()
    tcfg = TrainerConfig(algo="lag-wk", num_workers=W, lr=LR,
                         fastpath="on")
    got = {
        "topology": _refused(lambda: init_state(
            cfg, tcfg, device="cpu", mesh=mesh,
            topology=make_topology("pods:2"))),
        "legacy": _refused(lambda: make_train_step(
            cfg, tcfg.replace(fastpath="auto", use_pallas_comm=True),
            mesh=mesh)),
        "mixed": _refused(lambda: init_state(
            get_config("mamba2-370m").reduced(dtype="bfloat16",
                                              param_dtype="bfloat16"),
            tcfg, device="cpu", mesh=mesh)),
        "workers": _refused(lambda: init_state(
            cfg, tcfg.replace(num_workers=3), device="cpu", mesh=mesh)),
    }
    # the plane is off for CPU tensors under "auto": a trigger on a row
    # shard would read a shard's norm
    auto = tcfg.replace(fastpath="auto")
    state = init_state(cfg, auto, device="cpu", mesh=mesh)
    got["plane"] = _refused(lambda: make_train_step(cfg, auto, mesh=mesh)(
        state, batch(cfg)))
    return got


def placements(mesh, rank):
    """The reduced llama's parameters and a batch placed as DTensors on
    the mesh: each local shard's shape and its values, against the whole
    tensors and the rules' spec."""
    cfg = config()
    from repro_torch.models import model
    params = model.init(cfg, device="cpu", seed=0)
    b = batch(cfg)
    out = []
    for tree, placed, specs in (
            (params, sharding.tree_shardings(params, mesh),
             sharding.tree_specs(params, mesh)),
            (b, sharding.batch_shardings(b, mesh),
             sharding.batch_specs(b, mesh))):
        leaves = tree_leaves(tree)
        spec_leaves = tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, sharding.PartitionSpec))
        for t, d, s in zip(leaves, tree_leaves(placed), spec_leaves):
            idx = sharding.local_slices(s, t.shape, mesh, {"data": rank})
            local = d.to_local()
            out.append((tuple(s), tuple(t.shape), tuple(local.shape),
                        bool(torch.equal(local, t[idx]))))
            del d
    return out


def world(rank, N, ref_params, ckpt_dir, full=True):
    """Every case of a world of N ranks: the algos at W (``full``: plus a
    bfloat16 lag-wk run, the checkpoint round trip, the launcher, the
    placements and the refusals); at N = 3, lag-wk at W = 3."""
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh("cpu")
    got = {}
    if not full:
        got["lag-wk"] = run_case("lag-wk", ref_params, mesh, workers=N)
        return got
    for algo in ALGOS:
        got[algo] = run_case(algo, ref_params, mesh,
                             ckpt_dir=ckpt_dir if algo == CKPT_ALGO
                             else None)
    got["bf16"] = run_case("lag-wk", ref_params, mesh, dtype="bfloat16")
    got["predicted"] = {a: row_shards.predicted_records(
        config(), TrainerConfig(algo=a, num_workers=W), mesh)
        for a in ALGOS}
    got["placements"] = placements(mesh, rank)
    got["refusals"] = refusals(mesh)
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(LAUNCH_ARGV + ["--ranks", str(N), "--dist-backend",
                                  "gloo"])
    got["launcher"] = buf.getvalue().splitlines()
    return got


# ---------------------------------------------------------------------------
# The plane on row shards, N ranks simulated in one process
# ---------------------------------------------------------------------------

def _layout():
    """An unaligned layout: 5 leaves over 29 blocks of rows (a prime)."""
    from repro_torch.fastpath.layout import FlatLayout
    tree = {"a": torch.zeros(300, 333), "b": torch.zeros(7),
            "c": torch.zeros(64, 1024), "d": torch.zeros(1000, 777),
            "e": torch.zeros(5, 5)}
    lo = FlatLayout.for_tree(tree)
    assert lo.nblocks == 29
    return lo


def _pad(buf, rows):
    out = torch.zeros(buf.shape[:-2] + (rows, 128), dtype=buf.dtype,
                      device=buf.device)
    out[..., :buf.shape[-2], :] = buf
    return out


def row_shard_plan_case(N, device, W=3):
    """``fastpath.plan.RowShardPlan`` on each of N row shards of an
    unaligned layout (the gather done by hand: every rank's partials
    stacked in rank order) against the one-rank plane on ``device``:
    ‖g − ĝ‖², ‖θ̂ − θ‖², LAQ's steps and ‖p‖² bitwise, each rank's payload
    and residual rows bitwise the one-rank buffers' and their padding
    zero."""
    from repro_torch.fastpath import kernels
    from repro_torch.fastpath import plan as plan_lib
    from repro_torch.fastpath.layout import RowShard
    lo = _layout()
    gen = torch.Generator(device=device).manual_seed(N)
    g, q, e = (torch.randn((W, lo.rows, 128), generator=gen, device=device)
               for _ in range(3))
    theta = torch.randn((lo.rows, 128), generator=gen, device=device)
    for x in (g, q, e):
        x[:, lo.nsubs * 8:] = 0            # the layout's zero tail
    theta[lo.nsubs * 8:] = 0
    one = plan_lib.FastPathPlan("on")
    want = (one.delta_sqnorm(g, q, lo), one.delta_sqnorm(q, theta, lo),
            *one.laq_encode(g, q, e, lo, bits=4))
    shards = [RowShard(lo.rows, N, r) for r in range(N)]
    R = shards[0].shard_rows
    assert R * N >= lo.rows > R * (N - 1)
    gp, qp, ep = (_pad(x, R * N) for x in (g, q, e))
    tp = _pad(theta, R * N)

    def cut(s, x):
        """Rank s's rows of a padded buffer, as the rank holds them: a
        buffer of its own (a stacked buffer's row slice is not
        contiguous)."""
        return s.of(x).contiguous()
    # every rank's partials of each gathered reduction, in call order
    parts = {"delta_sqnorm": [[kernels.delta_sqnorm_blocks(cut(s, gp),
                                                           cut(s, qp)),
                               kernels.delta_sqnorm_blocks(cut(s, qp),
                                                           cut(s, tp))]
                              for s in shards],
             "absmax": [kernels.absmax_blocks(cut(s, gp), cut(s, qp),
                                              cut(s, ep)) for s in shards]}
    steps = want[5]
    parts["laq_sq"] = [kernels.laq_encode_blocks(
        cut(s, gp), cut(s, qp), cut(s, ep),
        steps[:, torch.as_tensor(s.sub_leaf(lo), dtype=torch.long,
                                 device=device)], 4)[2] for s in shards]
    for sh in shards:
        calls = {"delta_sqnorm": 0}

        def gather(x, what):
            if what == "delta_sqnorm":
                i = calls["delta_sqnorm"]
                calls["delta_sqnorm"] += 1
                return torch.stack([p[i] for p in parts[what]])
            return torch.stack(parts[what])
        plan = plan_lib.RowShardPlan("on", lo, sh, gather)
        sl = sh.layout(torch.float32)
        got = (plan.delta_sqnorm(cut(sh, gp), cut(sh, qp), sl),
               plan.delta_sqnorm(cut(sh, qp), cut(sh, tp), sl),
               *plan.laq_encode(cut(sh, gp), cut(sh, qp), cut(sh, ep), sl,
                                bits=4))
        v = sh.valid
        for i in (0, 1, 4, 5):              # the sums and the steps
            assert torch.equal(got[i], want[i]), (N, sh.rank, i)
        for i in (2, 3):                    # payload and residual rows
            assert torch.equal(got[i][:, :v],
                               want[i][:, sh.start:sh.start + v]), (N, i)
            assert not got[i][:, v:].any()
