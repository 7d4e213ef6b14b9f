"""Topologies: WHERE the lazy-aggregation units live — port of
``repro.engine.topology`` (``sim`` and ``shards``).

  SimWorkers   the paper's parameter-server simulation: the units are the
               M convex workers; K rounds of ``engine.rounds.lag_round``
               on the flat buffers of a one-leaf ``(d,)`` layout
  BatchShards  the deep trainer: the units are slices of the global batch
               (rows m·B/W:(m+1)·B/W), deltas reduced by plain sum

``make_topology`` takes ``"sim"`` or ``"shards"``; the reference's other
topologies (pods, async, devices, fleet, graph) are not ported yet and
raise.  Simulated wall-clock for an upload mask comes from
``repro_torch.netsim.cluster``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import lag
from repro_torch.engine import rounds
from repro_torch.engine.report import RunReport
from repro_torch.engine.server import ServerOptimizer
from repro_torch.fastpath import plan as plan_lib
from repro_torch.fastpath.layout import FlatLayout
from repro_torch.netsim import hetero as netsim_hetero


def split_batch(batch: Dict[str, torch.Tensor], num_workers: int) -> Dict:
    """Reshape every leaf's batch dim into a leading worker dim:
    ``(B, …) → (W, B/W, …)`` — worker m gets rows ``m·B/W:(m+1)·B/W``."""
    W = num_workers
    out = {}
    for key, x in batch.items():
        B = x.shape[0]
        if B % W:
            raise ValueError(f"batch dim {B} not divisible by {W} workers"
                             f" at {key!r}")
        out[key] = x.reshape((W, B // W) + tuple(x.shape[1:]))
    return out


class BatchShards:
    """Batch-shard workers reduced by plain sum — the flat trainer."""
    name = "shards"

    def place_batch(self, batch: Dict, num_units: int) -> Dict:
        return split_batch(batch, num_units)


class SimWorkers:
    """The paper's Sec.-4 parameter-server simulation: full-batch gradients
    per convex worker, K rounds of :func:`repro_torch.engine.rounds.
    lag_round` in a host loop.

    θ, the gradients and the mirror state are the flat buffers of the
    one-leaf ``(d,)`` layout, in the problem's dtype (LAQ's residual in
    float32).  A policy whose plan is active (float32 on CUDA, or forced)
    runs the batched plane; a float64 problem gets a policy without a plan
    from the engine's front door (``Experiment``) and runs the plain
    route.  The loss is taken before each round and kept on the device;
    masks and losses are stacked once at the end, so the loop never waits
    for the device.
    """
    name = "sim"

    def run(self, problem, policy, server: ServerOptimizer,
            lagcfg: lag.LAGConfig, *, K: int, seed: int = 0,
            theta0=None, opt_loss: Optional[float] = None) -> RunReport:
        M, d = problem.num_workers, problem.dim
        dev, dt = problem.device, problem.dtype
        theta0 = torch.zeros((d,), dtype=dt, device=dev) if theta0 is None \
            else torch.as_tensor(theta0).to(dev, dt)
        lo = FlatLayout.for_tree(theta0)
        theta = lo.flatten(theta0)
        # Initialization (paper Alg. 1/2 line 2): all workers upload at
        # k=0 — the policy mirrors start at the exact ∇L_m(θ⁰), ∇ at their
        # sum (added in worker order), θ̂ at θ⁰
        g0 = problem.worker_grads(theta0)                  # (M, d)
        grad_hat = lo.flatten_stacked(g0)
        theta_hat = lo.flatten_stacked(theta0.expand(M, d)) \
            if policy.needs_theta_hat else None
        lag_state = dict(policy.init_state(grad_hat, theta_hat))
        lag_state.update(
            nabla=rounds.sum_reduce(None, grad_hat),
            hist=lag.hist_init(lagcfg.D, dev),
            comm_total=torch.zeros((), dtype=torch.int32, device=dev),
            comm_per_worker=torch.zeros((M,), dtype=torch.int32, device=dev),
            L_m=problem.L_m,
        )
        opt = server.init(theta)
        plane = plan_lib.active_plan(policy, theta) is not None

        losses, masks, underflow = [], [], []
        for k in range(K):
            theta_t = lo.unflatten(theta)
            losses.append(server.composite_loss(problem.loss(theta_t),
                                                theta_t))
            grads = lo.flatten_stacked(problem.worker_grads(theta_t))
            gah = None
            if policy.needs_grad_at_hat:
                # ∇L_m(θ̂_m) in the form the round consumes: one stacked
                # buffer for the plane, one buffer per worker otherwise
                ga = lo.flatten_stacked(problem.worker_grads_at(
                    lo.unflatten_stacked(lag_state["theta_hat"])))
                gah = [ga] if plane else list(ga.unbind(0))
            draw = policy.draw(k, M, seed) if policy.needs_rng else None
            theta, opt, lag_state, metrics = rounds.lag_round(
                policy, server, lagcfg, theta=theta, layout=lo,
                opt_state=opt, lag_state=lag_state, grads=grads, step=k,
                grad_at_hat=gah, draw=draw)
            masks.append(metrics["comm_mask"])
            underflow.append(metrics["trigger_rhs_underflow"])
            del grads, gah
        losses = torch.stack(losses).cpu().numpy()
        comm_mask = torch.stack(masks).cpu().numpy()
        n_underflow = int(torch.stack(underflow).sum())
        if opt_loss is None:
            _, opt_loss = problem.optimum()
        # the netsim measurables (paper Sec. 3): realized smoothness
        # spread + the trigger-derived heterogeneity score
        extras = {
            "trigger_rhs_underflow_rounds": n_underflow,
            "L_m_spread": netsim_hetero.realized_spread(problem.L_m),
            "hetero_score": netsim_hetero.hetero_score(
                problem.L_m, alpha=lagcfg.alpha, xi=lagcfg.xi, D=lagcfg.D,
                num_workers=M),
        }
        return RunReport(
            algo=policy.name, losses=losses, comm_mask=comm_mask,
            opt_loss=float(opt_loss),
            bytes_per_upload=policy.wire_bytes(g0[0]), server=server.name,
            topology=self.name, extras=extras)


# ---------------------------------------------------------------------------
# Registry + spec parsing
# ---------------------------------------------------------------------------

TOPOLOGIES = {
    "sim": SimWorkers,
    "shards": BatchShards,
}

#: the reference's other topologies (ROADMAP queue 1 item 4)
NOT_PORTED = ("pods", "async", "devices", "fleet", "graph")


def make_topology(spec):
    """Build a topology from its name (or pass one through): ``"sim"`` or
    ``"shards"``.  The reference's ``pods``, ``async``, ``devices``,
    ``fleet`` and ``graph`` raise: they are not ported yet.  The port's
    topologies take no ``:<units>`` count: the problem or the trainer's
    config fixes the number of workers.
    """
    if isinstance(spec, tuple(TOPOLOGIES.values())):
        return spec
    name = spec.partition("@")[0].partition(":")[0].strip() \
        if isinstance(spec, str) else None
    if name in NOT_PORTED:
        raise ValueError(f"topology {spec!r}: {name!r} is not ported yet; "
                         f"the port has {tuple(TOPOLOGIES)}")
    if spec not in TOPOLOGIES:
        raise ValueError(f"unknown topology {spec!r}; the port has "
                         f"{tuple(TOPOLOGIES)}, without a unit count")
    return TOPOLOGIES[spec]()
