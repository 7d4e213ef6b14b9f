"""Distributed LAG trainer — port of ``repro.dist.lag_trainer``.

A "worker" is a slice of the global batch (rows ``m·B/W:(m+1)·B/W``).
Each step computes every worker's loss and gradient — the reference's
``jax.vmap(value_and_grad)`` becomes a loop over workers, each writing its
gradients into slot m of one flat ``(W, rows, 128)`` buffer — and hands the
round to ``repro_torch.engine.rounds.lag_round``.  LASG-WK adds a second
backward pass per worker at its last-upload iterate θ̂_m.  Algorithms:

  gd, lag-wk, lag-ps, laq   as in ``repro_torch.comm``
  lasg-wk                   the stochastic worker trigger (Chen et al. 2020)
  adam, lag-adam            GD / the 15a trigger with an Adam server step

plus any ``repro_torch.comm.make_policy`` spec (``"laq@8"``,
``"cyc-iag"``, ``"num-lag-wk"``, …); ``TrainerConfig.server`` overrides the
server step with any ``repro_torch.engine.server`` spec
(``"prox-l1@1e-4"``, ``"momentum@0.9"``).

Memory at full width: the parameters live in ONE flat ``(rows, 128)``
buffer ``theta`` (float32, or the config's dtype for a bfloat16 or
float16 config) whose leaves
are views (so the comm plane's θ
operand and the server step need no copy), and the per-worker mirror state
(``grad_hat``, LAQ's ``resid``, LAG-PS's and LASG-WK's ``theta_hat``) is
kept natively as flat ``(W, rows, 128)`` buffers, updated in place on the
fast route, and so is the server's state (momentum's ``m``, Adam's
``mu``/``nu``: flat ``(rows, 128)`` buffers).  For
llama3.2-1b at W = 2 that is θ 4.9 GB + ∇ 4.9 GB + 9.9 GB per stacked
buffer in float32 (half each in bfloat16), instead of the several W-fold
copies a flatten/unflatten per call would hold.

bfloat16 and float16 (the reference's 2-byte training): a config whose
leaves are all bfloat16 (float16) keeps θ, ∇, the gradients, ĝ and θ̂ in
bfloat16 (float16) buffers (LAQ's residual stays float32, as the
reference's); ``TrainerConfig.grad_hat_dtype="bfloat16"`` (or
``"float16"``) keeps ĝ alone in that dtype.  A config that mixes a 2-byte
dtype and float32 leaves (the MoE router, mamba2's ``A_log``/
``dt_bias``/``D``, RG-LRU's ``b_a``/``b_i``) keeps each of these states as
a ``fastpath.layout.Parts`` pair, a 2-byte buffer over its 2-byte leaves
and a float32 one over its float32 leaves
(``fastpath.layout.MixedLayout``), so every leaf trains at its own dtype,
as in the reference; the plane launches each kernel once per part.  Both
comm routes train at bfloat16 and float16 on every topology but the gossip
graph, which refuses it by name (:func:`check_trainable`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import comm
from repro_torch.core import lag
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.engine import rounds as engine_rounds
from repro_torch.engine import server as server_lib
from repro_torch.engine.topology import BatchShards
from repro_torch.fastpath import plan as plan_lib
from repro_torch.fastpath.layout import (LANES, Layout, layout_for,
                                         parts_of, row)
from repro_torch.kernels.lag_trigger import ops as lag_ops
from repro_torch.models import model
from repro_torch.models.common import ModelConfig

ALGOS = ("gd", "lag-wk", "lag-ps", "laq", "lasg-wk", "adam", "lag-adam")
GRAD_HAT_DTYPES = (None, "bfloat16", "float16")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Trainer hyper-parameters.  ``lr`` is the stepsize on the MEAN
    aggregated gradient: θ^{k+1} = θ^k − (lr/M)·∇^k, i.e. eq. (4) with
    α = lr/M, and the triggers (15a)/(15b) read that same α.  ``algo`` is
    a name of :data:`ALGOS` or any ``repro_torch.comm.make_policy`` spec
    (``laq_bits`` is LAQ's width unless the spec says ``"laq@8"``);
    ``server`` overrides the algo's server step with any
    ``repro_torch.engine.server`` spec; ``momentum`` > 0 makes it heavy
    ball, the adam algos Adam (``adam_b1``/``adam_b2``).  ``rhs_floor``
    floors the trigger RHS (0.0: the paper's trigger).  ``fastpath`` is
    "auto" (the plane runs for CUDA tensors) or "on" (forced).
    ``use_pallas_comm`` selects the legacy per-leaf route instead of the
    plane: the per-leaf kernels' ``fused_tree_sqnorm`` as the triggers'
    norm and LAQ's per-leaf kernel encode; combined with ``fastpath="on"``
    it raises.  ``grad_hat_dtype`` (None, "bfloat16" or "float16", the
    reference's field) is the dtype of the ĝ mirrors, the parameters' dtype
    when None: a 2-byte dtype halves their bytes on a float32 model."""
    algo: str = "lag-wk"
    num_workers: int = 4
    lr: float = 0.05
    D: int = 10
    xi: float = 0.1
    grad_hat_dtype: Optional[str] = None
    momentum: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    laq_bits: int = 4
    use_pallas_comm: bool = False
    fastpath: str = "auto"
    server: Optional[str] = None
    rhs_floor: float = 0.0

    def __post_init__(self):
        self.comm_policy()      # raises on a bad spec, mode or combination
        if self.grad_hat_dtype not in GRAD_HAT_DTYPES:
            raise ValueError(f"grad_hat_dtype must be one of "
                             f"{GRAD_HAT_DTYPES}, got {self.grad_hat_dtype!r}")
        if self.server is not None:
            server_lib.make_server(self.server)   # validate the spec early

    @property
    def uses_adam(self) -> bool:
        return self.algo in ("adam", "lag-adam")

    @property
    def lag_rule(self) -> str:
        return "ps" if self.algo == "lag-ps" else "wk"

    def lag_config(self, num_units: Optional[int] = None) -> lag.LAGConfig:
        m = num_units or self.num_workers
        return lag.LAGConfig(num_workers=m, alpha=self.lr / m, D=self.D,
                             xi=self.xi, rule=self.lag_rule,
                             rhs_floor=self.rhs_floor)

    def comm_policy(self) -> comm.CommPolicy:
        """The policy this config selects (adam → GD uploads, lag-adam →
        the 15a trigger)."""
        sqnorm_fn = lag_ops.fused_tree_sqnorm if self.use_pallas_comm \
            else None
        return comm.make_policy(self.algo, bits=self.laq_bits,
                                use_pallas=self.use_pallas_comm,
                                sqnorm_fn=sqnorm_fn, fastpath=self.fastpath)

    def server_optimizer(self) -> server_lib.ServerOptimizer:
        """``server`` spec if set, else Adam for the adam algos, heavy ball
        when ``momentum > 0``, else the paper's SGD (eq. 4)."""
        if self.server is not None:
            return server_lib.make_server(self.server)
        if self.uses_adam:
            return server_lib.AdamServer(b1=self.adam_b1, b2=self.adam_b2)
        if self.momentum:
            return server_lib.MomentumServer(self.momentum)
        return server_lib.SGDServer()

    def replace(self, **kw) -> "TrainerConfig":
        return dataclasses.replace(self, **kw)


def param_layout(cfg: ModelConfig) -> Layout:
    """The flat layout of the model's parameter tree: one ``FlatLayout``,
    or a ``MixedLayout`` of two parts for a tree that mixes bfloat16 and
    float32 leaves."""
    return layout_for(model.templates(cfg))


def check_trainable(cfg: ModelConfig, tcfg: Optional[TrainerConfig] = None,
                    topology=None) -> None:
    """Refuse, by name, the 2-byte training the port does not run: the
    gossip graph on a bfloat16 or float16 tree (some of the parameters'
    leaves) or with a 2-byte ``grad_hat_dtype`` ("bfloat16" or "float16"
    alike).  The reference's deep graph step does not train a 2-byte tree:
    its float32 mixing weights promote the parameters to float32 in round 0
    and change the scan carry's dtype in round 1
    (``src/repro/graph/rounds.py:299``), so it defines no 2-byte graph
    arithmetic to hold a port to; and its edge mirrors stay float32
    whatever ``grad_hat_dtype`` says, so a 2-byte ĝ is a setting its graph
    does not honour, which the port refuses rather than ignore.  Every
    other topology, both comm routes and mixed trees train at bfloat16 and
    float16."""
    from repro_torch.graph.topology import GraphTopology
    if not isinstance(topology, GraphTopology):
        return
    if set(param_layout(cfg).dtypes) & {torch.bfloat16, torch.float16} or (
            tcfg is not None and tcfg.grad_hat_dtype is not None):
        raise NotImplementedError(
            "the graph topology at bfloat16 or float16 (parameters or "
            "grad_hat_dtype) is not ported: the reference's deep graph "
            "step does not train a 2-byte tree, nor honour grad_hat_dtype (its "
            "float32 mixing weights promote it in round 0 and change the "
            "scan carry's dtype in round 1, src/repro/graph/rounds.py:299), "
            "so it defines no 2-byte graph round to hold the port to")


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, device, seed: int = 0,
                params: Optional[Dict] = None,
                rows: Optional[int] = None) -> torch.Tensor:
    """The flat ``(rows, 128)`` θ buffer on ``device``, at the layout's
    dtype (a ``Parts`` pair for a tree of two dtypes): ``params`` (a
    parameter tree) copied in, or weights drawn from a ``torch.Generator``
    seeded with ``seed``.  ``rows`` (a tree of one dtype) pads the buffer
    with zero rows past the layout's (the row-sharded trainer's θ)."""
    device = torch.device(device)
    lo = param_layout(cfg)
    theta = lo.empty(device=device) if rows is None else torch.zeros(
        (rows, LANES), dtype=lo.dtype, device=device)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model.init_(lo.unflatten(theta), cfg, gen)
    else:
        lo.flatten(params, out=theta)
    return theta


def init_state(cfg: ModelConfig, tcfg: TrainerConfig, *, device,
               seed: int = 0, params: Optional[Dict] = None,
               policy=None, server=None, topology=None, mesh=None) -> Dict:
    """Fresh trainer state on ``device``.

    ``params`` (a parameter tree, e.g. from ``repro_torch.weights``) is
    copied into the flat θ buffer; without it the weights are drawn from a
    ``torch.Generator`` seeded with ``seed``.  ``grad_hat`` (and θ̂) start
    at zero with an empty history, so round 0 triggers every worker.  A
    stateful server's state (``opt``) is flat, beside θ; a topology's
    extra state (the pods' skip counter, the async ring) joins the lag
    group.  Dtypes as the reference's ``init_state``: θ, θ̂ and ∇ at the
    parameters' dtype, ĝ at ``tcfg.grad_hat_dtype`` (default: the
    parameters'), LAQ's residual float32.

    ``mesh`` (a host mesh, ``launch.mesh.make_host_mesh``): this rank's
    state of the row-sharded trainer (``dist.row_shards.init_state``).
    """
    if mesh is not None:
        from repro_torch.dist import row_shards
        return row_shards.init_state(cfg, tcfg, device=device, mesh=mesh,
                                     seed=seed, params=params, policy=policy,
                                     server=server, topology=topology)
    check_trainable(cfg, tcfg, topology)
    device = torch.device(device)
    W = tcfg.num_workers
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    lo = param_layout(cfg)
    theta = init_params(cfg, device=device, seed=seed, params=params)
    theta0 = lo.empty((W,), device) if policy.needs_theta_hat else None
    gh_dtype = getattr(torch, tcfg.grad_hat_dtype) if tcfg.grad_hat_dtype \
        else None
    lag_state = dict(policy.init_state(lo.empty((W,), device, gh_dtype),
                                       theta0))
    lag_state.update({
        "nabla": lo.empty(device=device),
        "hist": lag.hist_init(tcfg.D, device),
        "comm_total": torch.zeros((), dtype=torch.int32, device=device),
        "comm_per_worker": torch.zeros((W,), dtype=torch.int32,
                                       device=device),
    })
    if policy.needs_L_m:
        # no oracle L_m for a deep net: the 1/α heuristic (paper: α = 1/L)
        lag_state["L_m"] = torch.full((W,), 1.0 / tcfg.lr,
                                      dtype=torch.float32, device=device)
    if topology is not None:
        lag_state.update(topology.extra_state(theta))
    state = {"theta": theta, "lag": lag_state, "step": 0}
    opt0 = server.init(theta)
    if opt0 is not None:
        state["opt"] = opt0
    return state


def params_of(state: Dict, cfg: ModelConfig) -> Dict:
    """The parameter tree (views of the flat θ buffer)."""
    return param_layout(cfg).unflatten(state["theta"])


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def worker_grads(theta, lo: Layout, cfg: ModelConfig,
                 shards: Dict, out=None) -> Tuple[torch.Tensor, object]:
    """Every worker's (loss, gradient): losses (W,), gradient m written into
    ``out[m]`` — by default one zeroed (W, rows, 128) buffer; a list of W
    (rows, 128) buffers also serves (the padding stays zero).  ``theta``
    is the shared (rows, 128) iterate, or one iterate per worker (W, rows,
    128): LASG-WK's θ̂_m, whose leaves are views of row m."""
    W = next(iter(shards.values())).shape[0]
    first = parts_of(theta)[0]
    grads = lo.empty((W,), first.device) if out is None else out
    shared = first.dim() == 2
    losses = []
    for m in range(W):
        leaves, treedef = tree_flatten(lo.unflatten(
            theta if shared else row(theta, m)))
        req = [l.detach().requires_grad_() for l in leaves]
        shard = {k: v[m] for k, v in shards.items()}
        loss = model.loss_fn(tree_unflatten(treedef, req), cfg, shard)
        # a stack of no superblock (recurrentgemma cut to its tail) has
        # empty leaves the loss never reads: their gradients are empty
        g = torch.autograd.grad(loss, req, allow_unused=True,
                                materialize_grads=True)
        lo.flatten(tree_unflatten(treedef, list(g)), out=row(grads, m))
        losses.append(loss.detach())
        del g, req, leaves
    return torch.stack(losses), grads


def grads_at_hat(policy, theta: torch.Tensor, theta_hat: torch.Tensor,
                 lo: Layout, cfg: ModelConfig, shards: Dict) -> List:
    """LASG-WK's ∇ℓ_m(θ̂_m; ξ^k): each worker's gradient at its own θ̂_m on
    the current shard, in the form the round consumes
    (``engine.rounds.policy_rounds``): ``[one (W, rows, 128) buffer]`` for
    the plane, W separate (rows, 128) buffers for the plain route, so
    each worker's row is freed once its trigger has read it."""
    W = parts_of(theta_hat)[0].shape[0]
    if plan_lib.active_plan(policy, theta) is not None:
        return [worker_grads(theta_hat, lo, cfg, shards)[1]]
    rows = [lo.empty(device=parts_of(theta)[0].device) for _ in range(W)]
    worker_grads(theta_hat, lo, cfg, shards, out=rows)
    return rows


def phase_ms(metrics: Dict) -> Dict[str, float]:
    """{"grad_ms", "comm_ms"} from a finished step's CUDA events ({} on
    the CPU): device time of the workers' forward/backward, and of the
    comm plane + server step (a graph step's adapt + edge round); a fleet
    step adds "gather_ms" and "scatter_ms", a graph step "mix_ms" (the
    mixing and the history push)."""
    ev = metrics.get("phase_events")
    if not ev:
        return {}
    out = {"grad_ms": ev[0].elapsed_time(ev[1]),
           "comm_ms": ev[1].elapsed_time(ev[2])}
    fl = metrics.get("fleet_events")
    if fl:
        # the fleet's cohort gather (before the gradients) and its scatter
        # back (inside the comm phase)
        out.update(gather_ms=fl[0].elapsed_time(fl[1]),
                   scatter_ms=fl[2].elapsed_time(fl[3]))
    gr = metrics.get("graph_events")
    if gr:
        out["mix_ms"] = gr[0].elapsed_time(gr[1])
    return out


def make_train_step(cfg: ModelConfig, tcfg: TrainerConfig, policy=None,
                    server=None, topology=None, schedule_seed: int = 0,
                    mesh=None):
    """Build ``train_step(state, batch) → (state, metrics)``; the state's
    buffers are updated in place.  ``topology`` (default ``BatchShards``)
    places the batch, may hand each worker its own parameter view (the
    async ring: gradients and triggers at θ^{k−s_m}), reduces the masked
    deltas (the pods' quiet-round skip) and advances its views after the
    server step.  ``schedule_seed`` seeds a sampled schedule's per-round
    draw (num-IAG), deterministic in the step counter.  On the GPU, ``metrics["phase_events"]`` holds three CUDA
    events: before the gradients (both passes for LASG-WK), after them,
    after the round (read them with :func:`phase_ms` once the device has
    caught up).  ``mesh`` (a host mesh): this rank's step of the
    row-sharded trainer (``dist.row_shards.make_train_step``)."""
    if mesh is not None:
        from repro_torch.dist import row_shards
        return row_shards.make_train_step(cfg, tcfg, mesh=mesh, policy=policy,
                                          server=server, topology=topology,
                                          schedule_seed=schedule_seed)
    check_trainable(cfg, tcfg, topology)
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    topology = topology if topology is not None else BatchShards()
    reduce_fn = topology.reduce_fn()
    lo = param_layout(cfg)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        theta, lag_state = state["theta"], state["lag"]
        W = lag_state["comm_per_worker"].shape[0]
        lagcfg = tcfg.lag_config(num_units=W)
        shards = topology.place_batch(batch, W)
        # on the GPU, events split the round's device time into the
        # workers' forward/backward and the comm plane + server step
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if parts_of(theta)[0].is_cuda else None
        if events:
            events[0].record()
        # an async topology hands each worker the parameters it last saw
        views = topology.worker_views(theta, lag_state, W)
        losses, grads = worker_grads(theta if views is None else views, lo,
                                     cfg, shards)
        # the objective at the pre-step parameters (views of θ)
        loss = server.composite_loss(torch.mean(losses), lo.unflatten(theta))
        gah = None
        if policy.needs_grad_at_hat:
            gah = grads_at_hat(policy, theta, lag_state["theta_hat"], lo, cfg,
                               shards)
        draw = policy.draw(state["step"], W, schedule_seed) \
            if policy.needs_rng else None
        if events:
            events[1].record()
        theta, new_opt, new_lag, metrics = engine_rounds.lag_round(
            policy, server, lagcfg, theta=theta, layout=lo,
            opt_state=state.get("opt"), lag_state=lag_state, grads=grads,
            step=state["step"], grad_at_hat=gah, draw=draw,
            reduce_fn=reduce_fn, theta_view=views)
        del grads, gah, views
        adv = topology.advance_views(new_lag, theta)
        if adv:
            new_lag = dict(new_lag, **adv)
        if events:
            events[2].record()
            metrics["phase_events"] = events
        new_state = dict(state, theta=theta, lag=new_lag,
                         step=state["step"] + 1)
        if new_opt is not None:
            new_state["opt"] = new_opt
        metrics["loss"] = loss
        return new_state, metrics

    return train_step
