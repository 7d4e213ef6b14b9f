"""The trainer on a host mesh: the LAG state row-sharded over data ranks —
the port's counterpart of the reference's ``tree_shardings`` placement
of its trainer on ``make_host_mesh()``.

On the reference's (N devices, 1) ``("data", "model")`` host mesh its rules
(``repro_torch.dist.sharding``) shard every leaf of ``state['lag']['grad_hat']``,
``['theta_hat']`` and ``['nabla']`` over ``"data"`` and replicate the
rest, and GSPMD runs the step data-parallel: each device holds 1/N of ĝ,
θ̂ and ∇.  Here the same placement is made by hand on a
``torch.distributed`` group of N ranks (``launch.mesh.make_host_mesh``):

* θ (the flat ``(rows, 128)`` buffer whose leaves are views), the server's
  state, the history and the counters are replicated; every policy mirror
  (``grad_hat``, ``theta_hat``, LAQ's ``resid``) and ∇ are row shards: rank
  r holds rows ``[r·R, (r+1)·R)`` of each (``fastpath.layout.RowShard``: R
  a multiple of 256, θ padded to N·R rows with zeros).  The rules decide
  it: :func:`row_keys` asks ``sharding.spec_for`` of each flat buffer.
* Rank r owns workers ``r·W/N … (r+1)·W/N − 1`` and their batch rows
  (``sharding.batch_specs``: the batch dim over ``"data"``); it computes
  their losses and gradients into a ``(W/N, N·R, 128)`` buffer, and one
  all-to-all a round sends each worker's rows to the rank that holds them,
  so each rank then holds the round's ``(W, R, 128)`` gradient rows.
  LASG-WK's second pass first gathers each worker's whole θ̂_m on its
  owner (an all-to-all the other way), and its gradients go back as the
  first ones do.
* The round is ``engine.rounds``'s on the rank's rows: the comm plane's
  kernels on the ``(W, R, 128)`` shards (``fastpath.plan.RowShardPlan``:
  the per-sub-block partials gathered in rank order and folded in the
  plane's own order, so the triggers' sums, LAQ's absmax and the masks are
  bitwise the one-rank plane's), the masked folds of ĝ, θ̂ and the residual
  on the rows, ∇'s rows, then the server on the rank's rows of θ and its
  state, gathered back whole (``finish_round(rows=…)``).

So the trainer is bitwise the one-process ``shards:W`` trainer — masks,
losses, θ, ĝ rows — where each worker's backward pass is the one-process
run's (the same program on the same kind of device: no worker's batch rows
are split across ranks).  What it refuses, by name: a topology other than
``shards``, the legacy per-leaf route, a tree of two dtypes, a model axis
(tensor parallelism), and W not a multiple of N.  Every collective writes
one record (``dist.collectives``); ``sharding.row_shard_records`` predicts
them.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.dist import collectives, sharding
from repro_torch.dist import lag_trainer
from repro_torch.engine import rounds as engine_rounds
from repro_torch.engine.topology import BatchShards
from repro_torch.fastpath.layout import LANES, FlatLayout, RowShard
from repro_torch.fastpath.plan import RowShardPlan
from repro_torch.models.common import ModelConfig

#: the ROADMAP queue 1 items that take up what this trainer refuses
ITEM_TOPOLOGIES = "ROADMAP queue 1 item 9"
ITEM_LEGACY = "ROADMAP queue 1 item 10"
ITEM_MIXED = "ROADMAP queue 1 item 11"
ITEM_TENSOR_PARALLEL = "ROADMAP queue 1 item 12"


def mesh_group(mesh) -> Tuple[object, int, int]:
    """(the data axis's process group, its size N, this rank's index on
    it) of a host mesh; refuses a model axis of more than one rank."""
    shape = sharding.mesh_shape(mesh)
    if shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"a mesh with a model axis of {shape['model']} ranks is tensor "
            f"parallelism, which the port does not run: the row-sharded "
            f"trainer takes the host mesh (N, 1) over ('data', 'model') "
            f"({ITEM_TENSOR_PARALLEL})")
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"the row-sharded trainer runs on a DeviceMesh "
                        f"(launch.mesh.make_host_mesh), got {mesh!r}")
    import torch.distributed as dist
    group = mesh.get_group("data")
    return group, dist.get_world_size(group), dist.get_rank(group)


def check_shardable(cfg: ModelConfig, tcfg, policy, topology=None) -> None:
    """Refuse, by name, what the row-sharded trainer does not run."""
    if topology is not None and not type(topology) is BatchShards:
        raise NotImplementedError(
            f"--mesh host at more than one rank runs --topology shards; "
            f"{getattr(topology, 'name', topology)!r} under the host mesh "
            f"(the reference places pods, async and the fleet on it too) "
            f"is not ported ({ITEM_TOPOLOGIES})")
    if tcfg.use_pallas_comm or policy.fastpath is None:
        raise NotImplementedError(
            f"the legacy per-leaf route (use_pallas_comm=True, a policy "
            f"without the plane) under the host mesh is not ported: its "
            f"kernels reduce whole leaves, which a row shard cuts "
            f"({ITEM_LEGACY})")
    if not isinstance(lag_trainer.param_layout(cfg), FlatLayout):
        raise NotImplementedError(
            f"a tree of 2-byte and float32 leaves (fastpath.layout.Parts) "
            f"under the host mesh is not ported: each part would need a row "
            f"shard of its own ({ITEM_MIXED})")


def row_keys(policy, workers: int, padded_rows: int, mesh) -> Tuple[str, ...]:
    """The ``lag`` buffers held by rows: every policy mirror ((W, rows,
    128)) and ∇ ((rows, 128)).  The placement rules shard ``grad_hat``,
    ``theta_hat`` and ``nabla`` so over ``"data"`` (the worker dim
    protected, the rows the largest free dim); on a mesh of one rank they
    shard nothing, and a rank holds every row.  LAQ's ``resid`` is held by
    rows too, where the reference's rules replicate it (its ``_lag_spec``
    names only the three): its encode reads and writes it row by row beside
    ĝ, and a replicated residual would be gathered whole every round."""
    keys = tuple(policy.state_keys) + ("nabla",)
    N = sharding.mesh_shape(mesh).get("data", 1)
    for k in keys:
        if k == "resid":
            continue
        shape = (padded_rows, LANES) if k == "nabla" \
            else (workers, padded_rows, LANES)
        spec = sharding.spec_for(f"['lag'][{k!r}]", shape, mesh)
        want = sharding.P(*([None] * (len(shape) - 2) + ["data", None]))
        if N > 1 and spec != want:
            raise AssertionError(f"the rules place ['lag'][{k!r}] {shape} "
                                 f"as {spec}, not by rows: {want}")
    return keys


class RowShardComm:
    """A rank's collectives over the data axis, each one record in
    ``records`` (reset every round), and the server's row step."""

    def __init__(self, group, shard: RowShard):
        self.group, self.shard = group, shard
        self.records = []

    def all_gather(self, x: torch.Tensor, what: str) -> torch.Tensor:
        return collectives.all_gather(x, records=self.records, what=what,
                                      group=self.group).to(x.device)

    def all_to_all(self, x: torch.Tensor, what: str) -> torch.Tensor:
        return collectives.all_to_all(x, records=self.records, what=what,
                                      group=self.group)

    def gather_rows(self, buf: torch.Tensor, what: str) -> torch.Tensor:
        return collectives.all_gather_rows(buf, records=self.records,
                                           what=what, group=self.group)

    def server_step(self, server, theta, opt_state, nabla, step, lagcfg):
        """The server on this rank's rows of θ and of its state (∇ is
        the rank's rows), the rows then gathered into a new replicated θ
        and, in place, into the replicated state."""
        sh = self.shard
        opt_rows = None if opt_state is None else tree_map(sh.of, opt_state)
        new_rows, new_opt = server.apply(sh.of(theta), opt_rows, nabla, step,
                                         lagcfg)
        new_theta = torch.empty_like(theta)
        sh.of(new_theta).copy_(new_rows)
        del new_rows
        self.gather_rows(new_theta, "theta")
        if opt_state is not None:
            for i, (buf, mine, new) in enumerate(zip(
                    tree_leaves(opt_state), tree_leaves(opt_rows),
                    tree_leaves(new_opt))):
                if new is not mine:
                    mine.copy_(new)
                self.gather_rows(buf, f"opt{i}")
        return new_theta, opt_state


def local_batch(batch: Dict, mesh, rank: int) -> Dict:
    """This rank's rows of the global batch, as ``sharding.batch_specs``
    places them (batch dim over ``"data"``; ``positions3``'s axis 1)."""
    specs = sharding.batch_specs(batch, mesh)
    ranks = sharding.mesh_shape(mesh).get("data", 1)
    out = {}
    for k, v in batch.items():
        if v.dim() and ranks > 1 and "data" not in specs[k]:
            raise ValueError(f"batch leaf {k!r} {tuple(v.shape)}: its batch "
                             f"dim does not divide over the data ranks")
        out[k] = v[sharding.local_slices(specs[k], v.shape, mesh,
                                         {"data": rank})]
    return out


def _owner_major(buf: torch.Tensor, N: int) -> torch.Tensor:
    """(W/N, N·R, 128) rows of this rank's workers → (N·W/N, R, 128),
    chunk s the rows rank s holds (an all-to-all's input)."""
    Wl, rows, lanes = buf.shape
    R = rows // N
    return buf.view(Wl, N, R, lanes).transpose(0, 1).reshape(N * Wl, R,
                                                             lanes)


def _rows_major(buf: torch.Tensor, N: int) -> torch.Tensor:
    """(N·W/N, R, 128) with chunk s from rank s → (W/N, N·R, 128): each of
    this rank's workers whole."""
    NW, R, lanes = buf.shape
    Wl = NW // N
    return buf.view(N, Wl, R, lanes).transpose(0, 1).reshape(Wl, N * R,
                                                             lanes)


def _resolve(cfg: ModelConfig, tcfg, mesh, policy, server, topology):
    """(policy, server, the data group, the layout, this rank's row
    shard), each refusal checked."""
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    check_shardable(cfg, tcfg, policy, topology)
    group, N, rank = mesh_group(mesh)
    if tcfg.num_workers % N:
        raise ValueError(f"the host mesh's {N} data ranks must divide the "
                         f"{tcfg.num_workers} workers (rank r owns W/N of "
                         f"them)")
    lo = lag_trainer.param_layout(cfg)
    return policy, server, group, lo, RowShard(lo.rows, N, rank)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig, tcfg, *, device, mesh, seed: int = 0,
               params: Optional[Dict] = None, policy=None, server=None,
               topology=None) -> Dict:
    """This rank's trainer state on the host mesh: θ whole (padded to N·R
    rows), the policy mirrors ``(W, R, 128)`` and ∇ ``(R, 128)`` of this
    rank's rows, the history, counters, L_m and the server's state whole.
    Values as ``lag_trainer.init_state``'s (θ from ``params`` or the seeded
    draw every rank makes alike)."""
    policy, server, _, lo, shard = _resolve(cfg, tcfg, mesh, policy,
                                            server, topology)
    W = tcfg.num_workers
    device = torch.device(device)
    row_keys(policy, W, shard.padded_rows, mesh)
    theta = lag_trainer.init_params(cfg, device=device, seed=seed,
                                    params=params, rows=shard.padded_rows)

    def stacked(dtype):
        return torch.zeros((W, shard.shard_rows, LANES), dtype=dtype,
                           device=device)

    gh = getattr(torch, tcfg.grad_hat_dtype) if tcfg.grad_hat_dtype \
        else lo.dtype
    lag_state = dict(policy.init_state(
        stacked(gh), stacked(lo.dtype) if policy.needs_theta_hat else None))
    lag_state.update({
        "nabla": torch.zeros((shard.shard_rows, LANES), dtype=lo.dtype,
                             device=device),
        "hist": lag.hist_init(tcfg.D, device),
        "comm_total": torch.zeros((), dtype=torch.int32, device=device),
        "comm_per_worker": torch.zeros((W,), dtype=torch.int32,
                                       device=device),
    })
    if policy.needs_L_m:
        lag_state["L_m"] = torch.full((W,), 1.0 / tcfg.lr,
                                      dtype=torch.float32, device=device)
    state = {"theta": theta, "lag": lag_state, "step": 0}
    opt0 = server.init(theta)
    if opt0 is not None:
        state["opt"] = opt0
    return state


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tcfg, *, mesh, policy=None,
                    server=None, topology=None, schedule_seed: int = 0):
    """Build this rank's ``train_step(state, batch) → (state, metrics)``
    on the host mesh.  ``batch`` is the GLOBAL batch (every rank makes the
    same one); the rank takes its rows.  ``metrics`` are
    ``lag_trainer.make_train_step``'s (``loss``, ``comm_mask``,
    ``comm_this_round``, ``comm_total``, ``wire_bytes_total`` from
    ``policy.wire_bytes``, …, the same on every rank), plus ``records``,
    the round's collective records, and on the GPU ``phase_events``."""
    policy, server, group, lo, shard = _resolve(cfg, tcfg, mesh, policy,
                                                server, topology)
    W, N, rank = tcfg.num_workers, shard.ranks, shard.rank
    rs = RowShardComm(group, shard)
    # the policy's plane, on this rank's rows (a copy: the caller's
    # policy keeps its own)
    policy = copy.copy(policy)
    base = policy.fastpath
    policy.fastpath = RowShardPlan(base.mode, lo, shard, rs.all_gather)
    gd_payload = not sharding.plane_reductions(policy)
    topology = BatchShards()
    Wl = W // N
    shard_lo = shard.layout(lo.dtype)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        theta, lag_state, k = state["theta"], state["lag"], state["step"]
        if not (gd_payload or policy.fastpath.enabled_for(theta)):
            raise ValueError(
                f"the row-sharded trainer runs {policy.name}'s trigger on "
                f"the comm plane (a norm of a row shard is not a worker's): "
                f"pass fastpath='on' (--fastpath on) for CPU tensors")
        rs.records = []
        lagcfg = tcfg.lag_config(num_units=W)
        shards = topology.place_batch(local_batch(batch, mesh, rank), Wl)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if theta.is_cuda else None
        if events:
            events[0].record()
        mine = torch.zeros((Wl, shard.padded_rows, LANES), dtype=lo.dtype,
                           device=theta.device)
        losses, mine = lag_trainer.worker_grads(theta, lo, cfg, shards,
                                                out=mine)
        grads = rs.all_to_all(_owner_major(mine, N), "grads")
        del mine
        gah = None
        if policy.needs_grad_at_hat:
            hat = _rows_major(rs.all_to_all(lag_state["theta_hat"],
                                            "theta_hat"), N)
            at_hat = torch.zeros_like(hat)
            _, at_hat = lag_trainer.worker_grads(hat, lo, cfg, shards,
                                                 out=at_hat)
            del hat
            gah = [rs.all_to_all(_owner_major(at_hat, N), "grads_at_hat")]
            del at_hat
        gloss = rs.all_gather(losses, "loss").reshape(W)
        # the objective at the pre-step parameters (views of θ), of the
        # worker-order losses, as the one-process trainer's
        loss = server.composite_loss(torch.mean(gloss), lo.unflatten(theta))
        draw = policy.draw(k, W, schedule_seed) if policy.needs_rng else None
        if events:
            events[1].record()
        comm, delta, new_pst = engine_rounds.policy_rounds(
            policy, lagcfg, shard.of(theta), grads, lag_state,
            shard_lo, grad_at_hat=gah, step=k, draw=draw)
        del grads, gah
        sums = [engine_rounds.sum_reduce(comm, delta)]
        del delta
        theta, new_opt, new_lag, metrics = engine_rounds.finish_round(
            policy, server, lagcfg, theta=theta, layout=lo,
            opt_state=state.get("opt"), lag_state=lag_state, comm=comm,
            sum_delta=sums.pop(), new_pst=new_pst, step=k, rows=rs)
        if events:
            events[2].record()
            metrics["phase_events"] = events
        new_state = dict(state, theta=theta, lag=new_lag, step=k + 1)
        if new_opt is not None:
            new_state["opt"] = new_opt
        metrics.update(loss=loss, records=rs.records)
        return new_state, metrics

    return train_step


def predicted_records(cfg: ModelConfig, tcfg, mesh, policy=None,
                      server=None):
    """``sharding.row_shard_records`` for this config on ``mesh``: the
    records one round writes on each rank."""
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    _, N, rank = mesh_group(mesh)
    lo = lag_trainer.param_layout(cfg)
    meta = torch.empty((1,), dtype=lo.dtype, device="meta")
    opt = server.init(meta)
    return sharding.row_shard_records(
        policy, workers=tcfg.num_workers, ranks=N,
        shard_rows=RowShard(lo.rows, N, rank).shard_rows,
        itemsize=meta.element_size(),
        opt_itemsizes=[t.element_size() for t in tree_leaves(opt)]
        if opt is not None else ())


# ---------------------------------------------------------------------------
# Checkpoints: the shards:W file
# ---------------------------------------------------------------------------

def _whole_rows(group, buf: torch.Tensor, rows: int) -> torch.Tensor:
    """Every rank's rows of a row-sharded buffer ((…, R, 128)) → the
    one-process buffer (…, rows, 128) (on the host under gloo)."""
    g = collectives.all_gather(buf, group=group)     # (N, …, R, 128)
    lead = buf.dim() - 2
    g = torch.movedim(g, 0, lead)                    # (…, N, R, 128)
    return g.reshape(tuple(buf.shape[:lead]) + (-1, LANES))[..., :rows, :]


def save_checkpoint(ckpt_dir: str, step: int, state: Dict, cfg: ModelConfig,
                    mesh) -> None:
    """Every rank calls this: the row shards are gathered and rank 0
    writes the ``step_<step>.npz`` a one-process ``shards:W`` run writes at
    that step, bit for bit (θ and the server's state cut to the layout's
    rows)."""
    import torch.distributed as dist
    from repro_torch.checkpoint import store
    group, _, rank = mesh_group(mesh)
    rows = lag_trainer.param_layout(cfg).rows
    lag_state = dict(state["lag"])
    for k, v in state["lag"].items():
        if isinstance(v, torch.Tensor) and v.dim() >= 2:
            lag_state[k] = _whole_rows(group, v, rows)
    if rank == 0:
        out = dict(state, theta=state["theta"][:rows], lag=lag_state)
        if "opt" in state:
            out["opt"] = tree_map(lambda t: t[:rows], state["opt"])
        store.save(ckpt_dir, step, out)
    del lag_state
    dist.barrier(group)


def restore_checkpoint(ckpt_dir: str, state: Dict, cfg: ModelConfig, mesh,
                       step: Optional[int] = None) -> Tuple[Dict, int]:
    """Restore a ``shards:W`` checkpoint (or this trainer's) into this
    rank's ``state``, in place: θ and the replicated entries whole, this
    rank's rows of every row-sharded buffer (``store.restore(take=)``)."""
    from repro_torch.checkpoint import store
    _, N, rank = mesh_group(mesh)
    rows = lag_trainer.param_layout(cfg).rows
    sh = RowShard(rows, N, rank)
    lag_like, take = dict(state["lag"]), {}
    for k, v in state["lag"].items():
        if isinstance(v, torch.Tensor) and v.dim() >= 2:
            lag_like[k] = v[..., :sh.valid, :]
            take[f"['lag'][{k!r}]"] = (slice(None),) * (v.dim() - 2) + (
                slice(sh.start, sh.start + sh.valid),)
    like = dict(state, theta=state["theta"][:rows], lag=lag_like)
    if "opt" in state:
        like["opt"] = tree_map(lambda t: t[:rows], state["opt"])
    got, at = store.restore(ckpt_dir, like, step, take=take)
    return dict(state, step=got["step"]), at
