"""Fleet rounds: sample a k-cohort, run it through the engine's round seam,
fold the result back into the N-client population — port of
``repro.fleet.rounds``.

One fleet round (the deep step and the convex run share :func:`fleet_round`):

  1. churn + sample — advance the alive mask, score the clients
     (``selection``), draw a sorted k-cohort (``sampling.gumbel_top_k``)
     from the round's draws;
  2. gather — the cohort's compact mirror rows into fresh ``(k, rows,
     128)`` plane buffers (``Population.gather_state``);
  3. innovation — ‖∇L_m − ĝ_m‖² of every cohort client, read BEFORE the
     round (the round consumes the gradients: LAQ writes its payload over
     them); on the plane it is ``plan.delta_sqnorm``, kernel 1;
  4. the shared round — ``engine.rounds.policy_rounds`` on the cohort
     buffers, unchanged; clients that churned out mid-round have their
     upload masked and their delta zeroed (so ∇^k = Σ_m ĝ_m survives);
  5. server — ``engine.rounds.finish_round`` (∇^k recursion over ALL N
     stale gradients, the server step, the history push), the upload
     counter per client;
  6. scatter — the cohort's advanced buffers back into the compact rows
     (``index_copy_``; dropouts revert exactly), age and innovation
     bookkeeping.

Per-round work is O(k) plus the (N,) vectors.  With churn 0, uniform
selection and k = N the cohort is the identity and every step reduces to
the synchronous round: ``fleet:M@M`` is bitwise ``shards``, and the convex
``fleet:N@N`` bitwise ``sim``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lag
from repro_torch.core.tree import tree_map
from repro_torch.engine import rounds as engine_rounds
from repro_torch.engine.report import RunReport
from repro_torch.fastpath import plan as plan_lib
from repro_torch.fastpath.layout import FlatLayout, Layout, parts_of
from repro_torch.fleet import sampling
from repro_torch.fleet.population import MIRROR_PREFIX, Population
from repro_torch.fleet.selection import make_selection


def _innovation(policy, grads, grad_hat, layout: Layout) -> torch.Tensor:
    """(k,) float32 ‖∇L_m − ĝ_m‖² per cohort client — the LAG trigger LHS,
    carried forward as the client's lazy-selection score.  On an active
    plane one ``delta_sqnorm_blocks`` launch per part; otherwise leaf by
    leaf in float32, the leaves' sums added in tree order, as the
    reference."""
    plan = plan_lib.active_plan(policy, grads)
    if plan is not None and plan.supports(layout):
        return plan.delta_sqnorm(grads, grad_hat, layout)
    k = parts_of(grads)[0].shape[0]
    g = [t.view(k, -1) for t in parts_of(grads)]
    gh = [t.view(k, -1) for t in parts_of(grad_hat)]
    out = torch.zeros((k,), dtype=torch.float32, device=g[0].device)
    for _, part, p, n in layout.packed_segments():
        d = g[part][:, p:p + n].to(torch.float32) \
            - gh[part][:, p:p + n].to(torch.float32)
        out = out + torch.sum(d * d, dim=1)
    return out


def sample_cohort(topology, lag_state: Dict, step: int, seed: int = 0,
                  chain: int = sampling.DEEP_CHAIN):
    """(alive', cohort, active) for round ``step``: the post-churn alive
    mask, the sorted (k,) client ids, and ``alive'[cohort]`` — the round's
    participation mask.  The draws are the topology's ``draw(step)`` when
    injected, else ``sampling.host_draws(seed, step, …, chain)``."""
    alive0 = lag_state["fleet_alive"]
    if topology.draw is not None:
        gumbel, uniforms = topology.draw(step)
    else:
        gumbel, uniforms = sampling.host_draws(
            seed, step, topology.population, topology.churn, chain)
    dev = alive0.device
    gumbel = torch.as_tensor(gumbel, dtype=torch.float32).to(dev)
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.float32).to(dev)
    alive = sampling.churn_step(uniforms, alive0, topology.churn)
    scores = make_selection(topology.selection)(lag_state)
    cohort = sampling.gumbel_top_k(gumbel, scores, alive, topology.cohort)
    return alive, cohort, alive[cohort]


def fleet_round(policy, server, lagcfg: lag.LAGConfig, *, topology,
                population: Population, theta, layout: Layout, opt_state,
                lag_state: Dict, alive: torch.Tensor, cohort: torch.Tensor,
                active: torch.Tensor, cohort_pst: Dict, grads, step: int,
                grad_at_hat=None,
                draw: Optional[int] = None,
                L_cohort: Optional[torch.Tensor] = None,
                scatter_events=None) -> Tuple[torch.Tensor, object, Dict,
                                              Dict]:
    """One sampled-cohort round (steps 3–6 above) on pre-gathered
    ``cohort_pst`` (the caller gathers, so LASG-WK's second pass can read
    θ̂).  Returns ``(theta, opt_state, lag_state, metrics)`` with
    ``lag_round``'s metric keys — ``comm_mask`` is population-wide (N,) —
    plus ``cohort_ids``, ``cohort_comm`` and ``cohort_active``.
    ``scatter_events`` (two CUDA events) time the scatter."""
    churny = topology.churn != 0.0
    k = topology.cohort
    cohort_lag = dict(cohort_pst, hist=lag_state["hist"])
    if policy.needs_L_m:
        if L_cohort is None:
            raise ValueError(f"policy {policy.name!r} needs per-unit L_m — "
                             f"pass L_cohort (the cohort's smoothness rows)")
        cohort_lag["L_m"] = L_cohort
    innov_m = _innovation(policy, grads, cohort_pst["grad_hat"], layout)

    comm, delta, new_pst = engine_rounds.policy_rounds(
        policy, lagcfg, theta, grads, cohort_lag, layout,
        grad_at_hat=grad_at_hat, step=step, draw=draw)
    del grads
    if churny:
        # mid-round dropouts: the upload never lands and the delta is
        # zeroed; their mirrors revert on the scatter
        comm = comm & active
        delta = tree_map(lambda d: d.masked_fill_(~active.view(k, 1, 1),
                                                  0.0), delta)
    sums = [engine_rounds.sum_reduce(comm, delta)]
    del delta
    theta, new_opt, new_lag, metrics = engine_rounds.finish_round(
        policy, server, lagcfg, theta=theta, layout=layout,
        opt_state=opt_state, lag_state=lag_state, comm=comm,
        sum_delta=sums.pop(), new_pst={}, step=step, index=cohort)

    if scatter_events:
        scatter_events[0].record()
    mirrors = population.scatter_state(lag_state, cohort, new_pst,
                                       active if churny else None)
    del new_pst, cohort_lag
    part = active if churny else torch.ones((k,), dtype=torch.bool,
                                            device=active.device)
    age = lag_state["fleet_age"] + 1
    age.index_copy_(0, cohort, torch.where(part, torch.zeros_like(
        age[cohort]), age[cohort]))
    innov_old = lag_state["fleet_innov"]
    innov = innov_old.index_copy(0, cohort, torch.where(
        part, innov_m, innov_old[cohort]))
    if scatter_events:
        scatter_events[1].record()
    new_lag.update(mirrors, fleet_alive=alive, fleet_age=age,
                   fleet_innov=innov)

    pop_mask = torch.zeros((population.size,), dtype=torch.bool,
                           device=comm.device).index_copy(0, cohort, comm)
    metrics.update(comm_mask=pop_mask, cohort_ids=cohort, cohort_comm=comm,
                   cohort_active=part)
    return theta, new_opt, new_lag, metrics


# ---------------------------------------------------------------------------
# Deep step (the trainer's shape: init_fleet_state + make_fleet_step)
# ---------------------------------------------------------------------------

def init_fleet_state(cfg, tcfg, topology, *, device, seed: int = 0,
                     params=None, policy=None, server=None) -> Dict:
    """Fresh fleet trainer state on ``device``: the trainer's ``{theta,
    lag, step[, opt]}`` with the lag group holding the compact population
    mirrors (zero: first contact uploads; float32 rows, ĝ gathered at the
    parameters' dtypes whatever ``tcfg.grad_hat_dtype``, as the
    reference's fleet) and a per-CLIENT (N,) ``comm_per_worker``."""
    from repro_torch.dist import lag_trainer
    lag_trainer.check_trainable(cfg, tcfg, topology)
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    device = torch.device(device)
    theta = lag_trainer.init_params(cfg, device=device, seed=seed,
                                    params=params)
    lo = lag_trainer.param_layout(cfg)
    pop = Population.for_policy(lo, policy, topology.population)
    lag_state = pop.init_state(device)
    lag_state.update(
        nabla=lo.empty(device=device),
        hist=lag.hist_init(tcfg.D, device),
        comm_total=torch.zeros((), dtype=torch.int32, device=device),
        comm_per_worker=torch.zeros((pop.size,), dtype=torch.int32,
                                    device=device),
    )
    state = {"theta": theta, "lag": lag_state, "step": 0}
    opt0 = server.init(theta)
    if opt0 is not None:
        state["opt"] = opt0
    return state


def make_fleet_step(cfg, tcfg, topology, policy=None, server=None,
                    schedule_seed: int = 0):
    """Build ``fleet_step(state, batch) → (state, metrics)``.  The batch is
    split over the k COHORT SLOTS (shard j → the j-th sampled client);
    gradients, triggers and the reduction are cohort-sized; ``lagcfg``
    normalises by the POPULATION (α = lr/N).  ``schedule_seed`` seeds the
    default cohort draws and a sampled schedule's.  On the GPU the metrics
    carry the trainer's ``phase_events`` and ``fleet_events`` (gather,
    scatter): read them with ``lag_trainer.phase_ms``."""
    from repro_torch.dist import lag_trainer
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    make_selection(topology.selection)          # validate the dial early
    N, k = topology.population, topology.cohort
    lagcfg = tcfg.lag_config(num_units=N)
    lo = lag_trainer.param_layout(cfg)
    pop = Population.for_policy(lo, policy, N)

    def fleet_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        theta, lag_state, step = state["theta"], state["lag"], state["step"]
        dev = parts_of(theta)[0].device
        events = [torch.cuda.Event(enable_timing=True) for _ in range(6)] \
            if dev.type == "cuda" else None
        alive, cohort, active = sample_cohort(topology, lag_state, step,
                                              seed=schedule_seed)
        shards = topology.place_batch(batch, k)
        if events:
            events[0].record()
        cohort_pst = pop.gather_state(lag_state, cohort)
        if events:
            events[1].record()
        losses, grads = lag_trainer.worker_grads(theta, lo, cfg, shards)
        loss = server.composite_loss(torch.mean(losses), lo.unflatten(theta))
        gah = None
        if policy.needs_grad_at_hat:
            # LASG-WK: the cohort's second backward pass at its own θ̂_m
            gah = lag_trainer.grads_at_hat(policy, theta,
                                           cohort_pst["theta_hat"], lo, cfg,
                                           shards)
        draw = policy.draw(step, k, schedule_seed) if policy.needs_rng \
            else None
        # deep runs have no oracle L_m: the sync trainer's 1/α heuristic
        L_cohort = torch.full((k,), 1.0 / tcfg.lr, dtype=torch.float32,
                              device=dev) \
            if policy.needs_L_m else None
        if events:
            events[2].record()
        theta, new_opt, new_lag, metrics = fleet_round(
            policy, server, lagcfg, topology=topology, population=pop,
            theta=theta, layout=lo, opt_state=state.get("opt"),
            lag_state=lag_state, alive=alive, cohort=cohort, active=active,
            cohort_pst=cohort_pst, grads=grads, step=step, grad_at_hat=gah,
            draw=draw, L_cohort=L_cohort,
            scatter_events=events[4:6] if events else None)
        del grads, gah, cohort_pst
        if events:
            events[3].record()
            metrics["phase_events"] = [events[1], events[2], events[3]]
            metrics["fleet_events"] = [events[0], events[1], events[4],
                                       events[5]]
        new_state = dict(state, theta=theta, lag=new_lag, step=step + 1)
        if new_opt is not None:
            new_state["opt"] = new_opt
        metrics["loss"] = loss
        return new_state, metrics

    return fleet_step


# ---------------------------------------------------------------------------
# Convex run (SimWorkers.run's shape, cohort-sampled)
# ---------------------------------------------------------------------------

def run_convex(problem, policy, server, lagcfg: lag.LAGConfig, topology, *,
               K: int, seed: int = 0, theta0=None,
               opt_loss: Optional[float] = None) -> RunReport:
    """Cohort-sampled convex run over an N-client ``Problem``.

    Initialization is the paper's Alg.-1 line 2 (every client uploads
    ∇L_m(θ⁰) once, one O(N) pass): the compact ĝ mirror holds the N
    gradients, ∇⁰ their sum in client order.  Each of the K rounds then
    takes the cohort's rows of the population's gradient: one product,
    O(N) flops, whose rows do not depend on the cohort (the reference
    differentiates only the cohort's rows; on the card a product of those
    alone gives other bits).  The iterates are recorded and
    the losses evaluated after the loop, as the reference does after its
    scan; the loop never waits for the device.
    """
    N = problem.num_workers
    if N != topology.population:
        raise ValueError(
            f"fleet population ({topology.population}) must equal the "
            f"problem's client count ({N}) — generate the problem at "
            f"population size (see repro_torch.fleet.problems."
            f"fleet_problem)")
    k, d = topology.cohort, problem.dim
    dev, dt = problem.device, problem.dtype
    theta0 = torch.zeros((d,), dtype=dt, device=dev) if theta0 is None \
        else torch.as_tensor(theta0).to(dev, dt)
    lo = FlatLayout.for_tree(theta0)
    theta = lo.flatten(theta0)
    pop = Population.for_policy(lo, policy, N)

    g0 = problem.worker_grads(theta0)                       # (N, d), once
    lag_state = pop.init_state(dev)
    lag_state[MIRROR_PREFIX + "grad_hat"] = lo.pack_stacked(g0)
    if policy.needs_theta_hat:
        lag_state[MIRROR_PREFIX + "theta_hat"] = lo.pack_stacked(
            theta0.expand(N, d))
    # ∇⁰ = Σ_m ∇L_m(θ⁰), added in client order (engine.rounds.sum_reduce's
    # order: the sync run's bits)
    nabla0 = g0[0].clone()
    for m in range(1, N):
        nabla0.add_(g0[m])
    lag_state.update(
        nabla=lo.flatten(nabla0),
        hist=lag.hist_init(lagcfg.D, dev),
        comm_total=torch.zeros((), dtype=torch.int32, device=dev),
        comm_per_worker=torch.zeros((N,), dtype=torch.int32, device=dev),
    )
    opt = server.init(theta)
    plane = plan_lib.active_plan(policy, theta) is not None

    thetas, masks, cohorts, ccomm, underflow = [], [], [], [], []
    for r in range(K):
        theta_t = lo.unflatten(theta)
        thetas.append(theta_t.clone())
        alive, cohort, active = sample_cohort(topology, lag_state, r,
                                              seed=seed,
                                              chain=sampling.CONVEX_CHAIN)
        # the cohort's rows of one population product, as in the sync run:
        # on the card a batched product's bits for a row depend on the
        # batch (cuBLAS), and round 0's innovation against g0's rows must
        # be exactly 0, as the reference's is
        grads = lo.flatten_stacked(problem.worker_grads(theta_t)[cohort])
        cohort_pst = pop.gather_state(lag_state, cohort)
        gah = None
        if policy.needs_grad_at_hat:
            ga = lo.flatten_stacked(problem.worker_grads_at(
                lo.unpack_stacked(lag_state[MIRROR_PREFIX + "theta_hat"])
            )[cohort])
            gah = [ga] if plane else list(ga.unbind(0))
        draw = policy.draw(r, k, seed) if policy.needs_rng else None
        L_cohort = problem.L_m[cohort] if policy.needs_L_m else None
        theta, opt, lag_state, metrics = fleet_round(
            policy, server, lagcfg, topology=topology, population=pop,
            theta=theta, layout=lo, opt_state=opt, lag_state=lag_state,
            alive=alive, cohort=cohort, active=active,
            cohort_pst=cohort_pst, grads=grads, step=r, grad_at_hat=gah,
            draw=draw, L_cohort=L_cohort)
        masks.append(metrics["comm_mask"])
        cohorts.append(metrics["cohort_ids"])
        ccomm.append(metrics["cohort_comm"])
        underflow.append(metrics["trigger_rhs_underflow"])
        del grads, gah, cohort_pst
    # diagnostics after the loop: the full-population objective at every
    # recorded iterate (the composite one a prox server adds to)
    losses = torch.stack([server.composite_loss(problem.loss(t), t)
                          for t in thetas]).cpu().numpy()
    if opt_loss is None:
        _, opt_loss = problem.optimum()
    from repro_torch.netsim import hetero as netsim_hetero
    extras = {
        "trigger_rhs_underflow_rounds": int(torch.stack(underflow).sum()),
        "L_m_spread": netsim_hetero.realized_spread(problem.L_m),
        "hetero_score": netsim_hetero.hetero_score(
            problem.L_m, alpha=lagcfg.alpha, xi=lagcfg.xi, D=lagcfg.D,
            num_workers=N),
        "population": N, "cohort": k,
        "churn": topology.churn, "selection": topology.selection,
        "cohort_ids": torch.stack(cohorts).cpu().numpy(),   # (K, k)
        "cohort_comm": torch.stack(ccomm).cpu().numpy(),    # (K, k)
    }
    return RunReport(
        algo=policy.name, losses=losses,
        comm_mask=torch.stack(masks).cpu().numpy(),
        opt_loss=float(opt_loss), bytes_per_upload=policy.wire_bytes(g0[0]),
        server=server.name, topology=topology.name, extras=extras)
