"""Distributed LAG trainer — port of ``repro.dist.lag_trainer``.

A "worker" is a slice of the global batch (rows ``m·B/W:(m+1)·B/W``).
Each step computes every worker's loss and gradient — the reference's
``jax.vmap(value_and_grad)`` becomes a loop over workers, each writing its
gradients into slot m of one flat ``(W, rows, 128)`` buffer — and hands the
round to ``repro_torch.engine.rounds.lag_round``.

Memory at full width: the parameters live in ONE flat ``(rows, 128)``
float32 buffer ``theta`` whose leaves are views (so the comm plane's θ
operand and the server step need no copy), and the per-worker mirror state
(``grad_hat``, LAQ's ``resid``, LAG-PS's ``theta_hat``) is kept natively as
flat ``(W, rows, 128)`` buffers, updated in place on the fast route.  For
llama3.2-1b at W = 2 that is θ 4.9 GB + ∇ 4.9 GB + 9.9 GB per stacked
buffer, instead of the several W-fold copies a flatten/unflatten per call
would hold.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import comm
from repro_torch.core import lag
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.engine import rounds as engine_rounds
from repro_torch.engine import server as server_lib
from repro_torch.engine.topology import BatchShards
from repro_torch.fastpath.layout import FlatLayout
from repro_torch.kernels.lag_trigger import ops as lag_ops
from repro_torch.models import model
from repro_torch.models.common import ModelConfig

ALGOS = ("gd", "lag-wk", "lag-ps", "laq")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Trainer hyper-parameters.  ``lr`` is the stepsize on the MEAN
    aggregated gradient: θ^{k+1} = θ^k − (lr/M)·∇^k, i.e. eq. (4) with
    α = lr/M, and the triggers (15a)/(15b) read that same α.  ``algo`` is
    any ``repro_torch.comm.make_policy`` spec (``"laq@8"`` sets LAQ's
    bits); ``fastpath`` is "auto" (the plane runs for CUDA tensors) or
    "on" (forced).  ``use_pallas_comm`` selects the legacy per-leaf route
    instead of the plane: the per-leaf kernels' ``fused_tree_sqnorm`` as
    the triggers' norm and LAQ's per-leaf kernel encode; combined with
    ``fastpath="on"`` it raises."""
    algo: str = "lag-wk"
    num_workers: int = 4
    lr: float = 0.05
    D: int = 10
    xi: float = 0.1
    fastpath: str = "auto"
    use_pallas_comm: bool = False

    def __post_init__(self):
        self.comm_policy()      # raises on a bad spec, mode or combination

    @property
    def lag_rule(self) -> str:
        return "ps" if self.algo == "lag-ps" else "wk"

    def lag_config(self, num_units: Optional[int] = None) -> lag.LAGConfig:
        m = num_units or self.num_workers
        return lag.LAGConfig(num_workers=m, alpha=self.lr / m, D=self.D,
                             xi=self.xi, rule=self.lag_rule)

    def comm_policy(self) -> comm.CommPolicy:
        sqnorm_fn = lag_ops.fused_tree_sqnorm if self.use_pallas_comm \
            else None
        return comm.make_policy(self.algo, use_pallas=self.use_pallas_comm,
                                sqnorm_fn=sqnorm_fn, fastpath=self.fastpath)

    def server_optimizer(self) -> server_lib.ServerOptimizer:
        """The paper's eq. (4); the other servers are not ported yet."""
        return server_lib.make_server("sgd")

    def replace(self, **kw) -> "TrainerConfig":
        return dataclasses.replace(self, **kw)


def param_layout(cfg: ModelConfig) -> FlatLayout:
    """The flat layout of the model's parameter tree."""
    return FlatLayout.for_tree(model.templates(cfg))


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig, tcfg: TrainerConfig, *, device,
               seed: int = 0, params: Optional[Dict] = None,
               policy=None) -> Dict:
    """Fresh trainer state on ``device``.

    ``params`` (a parameter tree, e.g. from ``repro_torch.weights``) is
    copied into the flat θ buffer; without it the weights are drawn from a
    ``torch.Generator`` seeded with ``seed``.  ``grad_hat`` starts at zero
    with an empty history, so round 0 triggers every worker.
    """
    device = torch.device(device)
    W = tcfg.num_workers
    policy = policy if policy is not None else tcfg.comm_policy()
    lo = param_layout(cfg)
    theta = lo.empty(device=device)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model.init_(lo.unflatten(theta), cfg, gen)
    else:
        lo.flatten(params, out=theta)
    theta0 = lo.empty((W,), device) if policy.needs_theta_hat else None
    lag_state = dict(policy.init_state(lo.empty((W,), device), theta0))
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
    return {"theta": theta, "lag": lag_state, "step": 0}


def params_of(state: Dict, cfg: ModelConfig) -> Dict:
    """The parameter tree (views of the flat θ buffer)."""
    return param_layout(cfg).unflatten(state["theta"])


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def worker_grads(theta: torch.Tensor, lo: FlatLayout, cfg: ModelConfig,
                 shards: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every worker's (loss, gradient): losses (W,), gradients written into
    one zeroed (W, rows, 128) buffer (the padding stays zero)."""
    W = next(iter(shards.values())).shape[0]
    grads = lo.empty((W,), theta.device)
    leaves, treedef = tree_flatten(lo.unflatten(theta))
    losses = []
    for m in range(W):
        req = [l.detach().requires_grad_() for l in leaves]
        shard = {k: v[m] for k, v in shards.items()}
        loss = model.loss_fn(tree_unflatten(treedef, req), cfg, shard)
        g = torch.autograd.grad(loss, req)
        lo.flatten(tree_unflatten(treedef, list(g)), out=grads[m])
        losses.append(loss.detach())
        del g, req
    return torch.stack(losses), grads


def phase_ms(metrics: Dict) -> Dict[str, float]:
    """{"grad_ms", "comm_ms"} from a finished step's CUDA events ({} on
    the CPU): device time of the workers' forward/backward, and of the
    comm plane + server step."""
    ev = metrics.get("phase_events")
    if not ev:
        return {}
    return {"grad_ms": ev[0].elapsed_time(ev[1]),
            "comm_ms": ev[1].elapsed_time(ev[2])}


def make_train_step(cfg: ModelConfig, tcfg: TrainerConfig, policy=None,
                    server=None, topology=None):
    """Build ``train_step(state, batch) → (state, metrics)``; the state's
    buffers are updated in place.  On the GPU, ``metrics["phase_events"]``
    holds three CUDA events: before the gradients, after them, after the
    round (read them with :func:`phase_ms` once the device has caught up)."""
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    topology = topology if topology is not None else BatchShards()
    lo = param_layout(cfg)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        theta, lag_state = state["theta"], state["lag"]
        W = lag_state["comm_per_worker"].shape[0]
        lagcfg = tcfg.lag_config(num_units=W)
        shards = topology.place_batch(batch, W)
        # on the GPU, events split the round's device time into the
        # workers' forward/backward and the comm plane + server step
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if theta.is_cuda else None
        if events:
            events[0].record()
        losses, grads = worker_grads(theta, lo, cfg, shards)
        loss = server.composite_loss(torch.mean(losses), None)
        if events:
            events[1].record()
        theta, new_opt, new_lag, metrics = engine_rounds.lag_round(
            policy, server, lagcfg, theta=theta, layout=lo,
            opt_state=state.get("opt"), lag_state=lag_state, grads=grads,
            step=state["step"])
        del grads
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
