"""Graph rounds: adapt locally, trigger per directed edge, mix lazily — port
of ``repro.graph.rounds``.

One decentralized round (the deep step and the convex run share these
helpers):

  1. **local gradients** — every node differentiates its OWN loss at its
     OWN iterate θ_i (there is no shared server θ);
  2. **adapt** — ψ_i = server.apply(θ_i, opt_i, W·∇L_i(θ_i)): every port
     server is elementwise, so ONE ``server.apply`` over the stacked
     ``(W, rows, 128)`` buffers is the reference's vmap.  It returns a new
     buffer: θ survives for the history push;
  3. **the edge round** — ``engine.rounds.policy_rounds``, unchanged, over
     the E directed edges at once: edge (j→i) communicates the source's
     fresh ψ_j against its ``grad_hat`` mirror ψ̂_{j→i} (the copy it last
     moved), so the 15a trigger fires on ‖ψ_j − ψ̂_{j→i}‖²; LAQ quantizes
     per edge with error feedback, the schedules cycle / sample the E edge
     slots, and on the plane one launch serves all E edges.  The round
     consumes its operands, so ψ_src = ψ[edge_src] is a buffer of its own
     (one ``index_select``, never a view of ψ); its delta, which no server
     sums, lands there and the buffer is scratch once the round is over;
  4. **mixing** — θ_i' = W_ii·ψ_i + Σ_e W_ij·ψ̂_e over the in-edges e of
     node i, in a fixed order: each destination's in-edge products are
     summed from the first, in edge order (XLA's ``segment_sum`` on the
     reference's side), and that sum is added to the own term.  No
     ``index_add_`` (atomic on CUDA), and the edges are never folded into
     the own term one by one (float addition is not associative);
  5. **history** — the trigger RHS window advances with the MEAN squared
     node movement (1/W)·Σ_i ‖θ_i' − θ_i‖².

Per-edge state lives in the lag group under ``edge_<key>``: one ``(E,
rows, 128)`` plane buffer per policy mirror, updated in place by the
round.  The reference keeps them packed (``(E, packed_cols)``) and
unpacks them every round; at full width a packed copy beside the plane
copy the kernels need does not fit one card (PERF.md §6), so the port
keeps the plane buffers only.

LASG-WK composes as in the reference: its ``grad_at_hat`` is the edge's
own mirror, so there is no second backward pass and its trigger coincides
with LAG-WK's on this plane.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lag
from repro_torch.engine import rounds as engine_rounds
from repro_torch.engine.report import RunReport
from repro_torch.engine.server import ServerOptimizer
from repro_torch.fastpath import plan as plan_lib
from repro_torch.fastpath.layout import FlatLayout
from repro_torch.netsim import hetero as netsim_hetero

#: lag-group key prefix of the per-edge mirror buffers
EDGE_PREFIX = "edge_"


def _check_policy(policy):
    if "grad_hat" not in policy.state_keys:
        raise ValueError(
            f"the graph plane stores each edge's last-transmitted iterate "
            f"in the policy's 'grad_hat' mirror; policy {policy.name!r} "
            f"has state_keys={policy.state_keys}")


@dataclasses.dataclass(frozen=True)
class EdgeMap:
    """The spec's edge structure on one device: ``src`` (E,) long for the
    gather, ``edge_w`` (E,) and ``self_w`` (W,) mixing weights cast to the
    iterate's dtype (float32 for the deep step, the problem's for the
    convex run, as the reference casts them), and each node's in-edges in
    edge order."""
    src: torch.Tensor
    edge_w: torch.Tensor
    self_w: torch.Tensor
    in_edges: Tuple[Tuple[int, ...], ...]

    @classmethod
    def of(cls, spec, dtype, device) -> "EdgeMap":
        dst = np.asarray(spec.edge_dst)
        return cls(
            src=torch.as_tensor(spec.edge_src, dtype=torch.long,
                                device=device),
            edge_w=torch.as_tensor(spec.edge_weights, dtype=dtype,
                                   device=device),
            self_w=torch.as_tensor(spec.self_weights, dtype=dtype,
                                   device=device),
            in_edges=tuple(tuple(int(e) for e in np.nonzero(dst == i)[0])
                           for i in range(spec.num_nodes)))


def init_edge_state(policy, theta0: torch.Tensor, num_edges: int,
                    D: int) -> Dict:
    """Fresh lag group for the flat ``(rows, 128)`` θ⁰: every edge's
    mirror starts at θ⁰ (every node knows the shared init), so round 0's
    innovation is the first adapt step and the dense policies all upload;
    LAQ's residual starts at zero.  Each mirror is a buffer of its own."""
    dev = theta0.device

    def copies():
        return theta0.unsqueeze(0).repeat(num_edges, 1, 1)

    pst = policy.init_state(copies(), copies() if policy.needs_theta_hat
                            else None)
    lag_state = {EDGE_PREFIX + k: v for k, v in pst.items()}
    lag_state.update(
        hist=lag.hist_init(D, dev),
        comm_total=torch.zeros((), dtype=torch.int32, device=dev),
        comm_per_worker=torch.zeros((num_edges,), dtype=torch.int32,
                                    device=dev),
    )
    return lag_state


def adapt(server: ServerOptimizer, thetas: torch.Tensor, opt_state,
          grads: torch.Tensor, step: int, nodecfg: lag.LAGConfig):
    """ψ = server.apply(θ, opt, W·∇) over the stacked ``(W, rows, 128)``
    buffers; the gradients are scaled in place (they are consumed).
    Returns ``(psi, opt_state)``, ψ a new buffer."""
    grads.mul_(thetas.shape[0])
    return server.apply(thetas, opt_state, grads, step, nodecfg)


def edge_round(policy, ecfg: lag.LAGConfig, psi: torch.Tensor,
               lag_state: Dict, layout: FlatLayout, *, edges: EdgeMap,
               L_edge: Optional[torch.Tensor], step: int,
               draw: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Step 3: the per-edge trigger / encode / decode over all E directed
    edges in one ``policy_rounds`` call.

    Returns ``(comm (E,) bool, scratch (E, rows, 128), new_pst)``:
    ``new_pst["grad_hat"]`` is the post-round received copy ψ̂_e the mixing
    reads (stale wherever ``comm`` is False), updated in place;
    ``scratch`` is ψ_src's buffer, free once the round is over.
    """
    psi_src = psi.index_select(0, edges.src)
    edge_lag = {k: lag_state[EDGE_PREFIX + k] for k in policy.state_keys}
    edge_lag["hist"] = lag_state["hist"]
    if L_edge is not None:
        edge_lag["L_m"] = L_edge
    gah = None
    if policy.needs_grad_at_hat:
        # LASG-WK is served from the edge's own mirror, in the form the
        # round consumes: the stacked buffer on the plane, its rows off it
        mirror = edge_lag["grad_hat"]
        plane = plan_lib.active_plan(policy, psi_src) is not None
        gah = [mirror] if plane else list(mirror.unbind(0))
    comm, delta, new_pst = engine_rounds.policy_rounds(
        policy, ecfg, psi_src, psi_src, edge_lag, layout, grad_at_hat=gah,
        step=step, draw=draw, theta_view=psi_src)
    # no server sums the delta (LAQ and the plain route wrote it over psi_src)
    del delta
    return comm, psi_src, new_pst


def mix(psi: torch.Tensor, mirrors: torch.Tensor, edges: EdgeMap, *,
        scratch: Optional[torch.Tensor] = None,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Step 4: θ_i' = W_ii·ψ_i + Σ_{e: dst(e)=i} W_i,src(e)·ψ̂_e over the
    stacked ``(W, …)`` ψ and ``(E, …)`` mirrors.  Each product is rounded,
    each destination's products are added in edge order starting from the
    first, and the sum is added to the rounded own term.  ``scratch`` (E,
    …) receives the products (a new buffer when None); ``out`` receives θ'
    and may be ``psi`` itself."""
    prods = torch.empty_like(mirrors) if scratch is None else scratch
    for e in range(mirrors.shape[0]):
        torch.mul(mirrors[e], edges.edge_w[e], out=prods[e])
    out = torch.empty_like(psi) if out is None else out
    for i, ins in enumerate(edges.in_edges):
        own = torch.mul(psi[i], edges.self_w[i], out=out[i])
        if not ins:
            continue
        recv = prods[ins[0]]
        for e in ins[1:]:
            recv.add_(prods[e])
        own.add_(recv)
    return out


def mean_sqdist(new: torch.Tensor, old: torch.Tensor, layout: FlatLayout
                ) -> torch.Tensor:
    """(1/W)·Σ_i ‖θ_i' − θ_i‖² over stacked buffers, summed leaf by leaf
    (``lag.tree_sqdist``), divided by W as a device tensor (an IEEE
    quotient on every device)."""
    s = lag.tree_sqdist(layout.unflatten_stacked(new),
                        layout.unflatten_stacked(old))
    return s / torch.full_like(s, float(new.shape[0]))


def _counters(lag_state: Dict, comm: torch.Tensor) -> Dict:
    comm_i = comm.to(torch.int32)
    return dict(
        comm_total=lag_state["comm_total"] + torch.sum(comm_i,
                                                       dtype=torch.int32),
        comm_per_worker=lag_state["comm_per_worker"] + comm_i)


def graph_round(policy, ecfg: lag.LAGConfig, *, thetas: torch.Tensor,
                psi: torch.Tensor, lag_state: Dict, layout: FlatLayout,
                edges: EdgeMap, L_edge: Optional[torch.Tensor], step: int,
                draw: Optional[int] = None, events=None):
    """Steps 3–5 on the stacked θ and the adapted ψ (the caller adapts and
    drops its gradients first: at full width they must not live through
    the edge round).  Returns ``(new_thetas, lag_state, comm)``; θ' is
    written into ψ's buffer, the mirrors are advanced in place.
    ``events`` (two CUDA events) bracket the mixing and the history
    push."""
    comm, scratch, new_pst = edge_round(policy, ecfg, psi, lag_state, layout,
                                        edges=edges, L_edge=L_edge,
                                        step=step, draw=draw)
    if events:
        events[0].record()
    new = mix(psi, new_pst["grad_hat"], edges, scratch=scratch, out=psi)
    del scratch
    hist = lag.hist_push(lag_state["hist"], mean_sqdist(new, thetas, layout))
    if events:
        events[1].record()
    new_lag = dict(lag_state, hist=hist, **_counters(lag_state, comm),
                   **{EDGE_PREFIX + k: v for k, v in new_pst.items()})
    return new, new_lag, comm


# ---------------------------------------------------------------------------
# Convex run (SimWorkers.run's shape, decentralized)
# ---------------------------------------------------------------------------

def run_convex(problem, policy, server, lagcfg: lag.LAGConfig, topology, *,
               K: int, seed: int = 0, theta0=None,
               opt_loss: Optional[float] = None) -> RunReport:
    """Decentralized convex run: node i owns worker i's data shard and its
    own iterate; K diffusion rounds in a host loop.

    The reported losses are the global objective at the CONSENSUS AVERAGE
    θ̄^k = (1/W)·Σ_i θ_i^k, recorded on the device before every round and
    evaluated after the loop (the loop never waits for the device);
    ``comm_mask`` is (K, E) over the directed edges.  A float64 problem
    runs the plain route (the front door gives it a policy without a
    plan), a float32 problem the caller's plane mode.
    """
    _check_policy(policy)
    spec = topology.spec
    W, E = spec.num_nodes, spec.num_edges
    if problem.num_workers != W:
        raise ValueError(
            f"graph has {W} nodes but the problem has "
            f"{problem.num_workers} workers — node i holds worker i's "
            f"shard, so the counts must match")
    d = problem.dim
    dev, dt = problem.device, problem.dtype
    theta0 = torch.zeros((d,), dtype=dt, device=dev) if theta0 is None \
        else torch.as_tensor(theta0).to(dev, dt)
    lo = FlatLayout.for_tree(theta0)
    edges = EdgeMap.of(spec, dt, dev)
    # the lazy units of the EDGE round are the E directed edges: the
    # trigger RHS normalizes by E and the schedules cycle / sample edges
    ecfg = dataclasses.replace(lagcfg, num_workers=E)
    L_edge = problem.L_m[edges.src] if policy.needs_L_m else None

    theta_flat = lo.flatten(theta0)
    lag_state = init_edge_state(policy, theta_flat, E, lagcfg.D)
    thetas = theta_flat.unsqueeze(0).repeat(W, 1, 1)
    opt = server.init(thetas)

    bars, masks, underflow = [], [], []
    for k in range(K):
        views = lo.unflatten_stacked(thetas)
        bars.append(torch.mean(views, dim=0))
        grads = lo.flatten_stacked(problem.worker_grads_at(views))
        del views
        psi, opt = adapt(server, thetas, opt, grads, k, lagcfg)
        del grads
        draw = policy.draw(k, E, seed) if policy.needs_rng else None
        underflow.append(lag.rhs_underflow(lag_state["hist"], ecfg, k))
        thetas, lag_state, comm = graph_round(
            policy, ecfg, thetas=thetas, psi=psi, lag_state=lag_state,
            layout=lo, edges=edges, L_edge=L_edge, step=k, draw=draw)
        masks.append(comm)
        del psi
    # diagnostics after the loop: the objective at every recorded consensus
    # average (the composite one a prox server adds to)
    losses = torch.stack([server.composite_loss(problem.loss(t), t)
                          for t in bars]).cpu().numpy()
    if opt_loss is None:
        _, opt_loss = problem.optimum()
    final = lo.unflatten_stacked(thetas)
    consensus = torch.sum((final - torch.mean(final, dim=0)) ** 2) / W
    extras = {
        "trigger_rhs_underflow_rounds": int(torch.stack(underflow).sum()),
        "L_m_spread": netsim_hetero.realized_spread(problem.L_m),
        "hetero_score": netsim_hetero.hetero_score(
            problem.L_m, alpha=lagcfg.alpha, xi=lagcfg.xi, D=lagcfg.D,
            num_workers=W),
        "graph_family": spec.family,
        "num_nodes": W, "num_edges": E,
        "spectral_gap": spec.spectral_gap,
        "edge_src": spec.edge_src,          # (E,) — netsim edge pricing
        "edge_dst": spec.edge_dst,          # (E,)
        "consensus_final": float(consensus),
    }
    return RunReport(
        algo=policy.name, losses=losses,
        comm_mask=torch.stack(masks).cpu().numpy(), opt_loss=float(opt_loss),
        bytes_per_upload=policy.wire_bytes(theta0), server=server.name,
        topology=topology.name, extras=extras)


# ---------------------------------------------------------------------------
# Deep step (the trainer's shape: init_graph_state + make_graph_step)
# ---------------------------------------------------------------------------

def init_graph_state(cfg, tcfg, topology, *, device, seed: int = 0,
                     params=None, policy=None, server=None) -> Dict:
    """Fresh graph trainer state on ``device``: ``theta`` is the STACKED
    ``(W, rows, 128)`` buffer of per-node iterates (all equal at init),
    the lag group holds the ``(E, rows, 128)`` per-edge mirrors and a
    per-EDGE (E,) ``comm_per_worker``; a stateful server's state is
    stacked per node."""
    from repro_torch.dist import lag_trainer
    lag_trainer.check_trainable(cfg, tcfg, topology)
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    _check_policy(policy)
    W, E = topology.num_nodes, topology.num_edges
    theta0 = lag_trainer.init_params(cfg, device=device, seed=seed,
                                     params=params)
    lag_state = init_edge_state(policy, theta0, E, tcfg.D)
    thetas = theta0.unsqueeze(0).repeat(W, 1, 1)
    del theta0
    state = {"theta": thetas, "lag": lag_state, "step": 0}
    opt0 = server.init(thetas)
    if opt0 is not None:
        state["opt"] = opt0
    return state


def node_params(state: Dict, cfg, node: int = 0) -> Dict:
    """Node ``node``'s parameter tree (views of the stacked θ)."""
    from repro_torch.dist import lag_trainer
    return lag_trainer.param_layout(cfg).unflatten(state["theta"][node])


def make_graph_step(cfg, tcfg, topology, policy=None, server=None,
                    schedule_seed: int = 0):
    """Build ``graph_step(state, batch) → (state, metrics)``.  The batch
    splits across the W nodes (node i trains on shard i at its OWN
    iterate); the per-edge round and the mixing follow the module
    docstring.  ``lagcfg`` keeps the trainer's α = lr/W, so each node's
    adapt of the W-scaled gradient moves it by lr·∇L_i.  On the GPU the
    metrics carry ``phase_events`` (fwd/bwd; adapt + edge round) and
    ``graph_events`` (the mixing and the history push): read them with
    ``lag_trainer.phase_ms``."""
    from repro_torch.dist import lag_trainer
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    _check_policy(policy)
    spec = topology.spec
    W, E = spec.num_nodes, spec.num_edges
    nodecfg = tcfg.lag_config(num_units=W)
    ecfg = dataclasses.replace(nodecfg, num_workers=E)
    lo = lag_trainer.param_layout(cfg)
    # the objective at the consensus average is only needed by a server
    # that adds to the loss (prox-l1)
    composite = type(server).composite_loss \
        is not ServerOptimizer.composite_loss

    def graph_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        thetas, lag_state, step = state["theta"], state["lag"], state["step"]
        dev = thetas.device
        edges = EdgeMap.of(spec, torch.float32, dev)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
            if thetas.is_cuda else None
        shards = topology.place_batch(batch, W)
        if events:
            events[0].record()
        losses, grads = lag_trainer.worker_grads(thetas, lo, cfg, shards)
        loss = torch.mean(losses)
        if composite:
            loss = server.composite_loss(
                loss, lo.unflatten(torch.mean(thetas, dim=0)))
        # deep runs have no oracle L_m: the sync trainer's 1/α heuristic
        L_edge = torch.full((E,), 1.0 / tcfg.lr, dtype=torch.float32,
                            device=dev) if policy.needs_L_m else None
        draw = policy.draw(step, E, schedule_seed) if policy.needs_rng \
            else None
        if events:
            events[1].record()
        rhs = lag.trigger_rhs(lag_state["hist"], ecfg)
        underflow = lag.rhs_underflow(lag_state["hist"], ecfg, step)
        psi, new_opt = adapt(server, thetas, state.get("opt"), grads, step,
                             nodecfg)
        del grads
        new_thetas, new_lag, comm = graph_round(
            policy, ecfg, thetas=thetas, psi=psi, lag_state=lag_state,
            layout=lo, edges=edges, L_edge=L_edge, step=step, draw=draw,
            events=events[2:] if events else None)
        del psi
        new_state = dict(state, theta=new_thetas, lag=new_lag, step=step + 1)
        if new_opt is not None:
            new_state["opt"] = new_opt
        n_up = torch.sum(comm.to(torch.int32), dtype=torch.int32)
        bytes_per_upload = policy.wire_bytes(lo.unflatten(new_thetas[0]))
        metrics = {
            "loss": loss,
            "comm_mask": comm,                      # (E,) per directed edge
            "comm_this_round": n_up,
            "comm_total": new_lag["comm_total"],
            "wire_bytes_this_round": n_up.to(torch.float32)
            * bytes_per_upload,
            "wire_bytes_total":
                new_lag["comm_total"].to(torch.float32) * bytes_per_upload,
            "trigger_rhs": rhs,
            "trigger_rhs_underflow": underflow,
            "skipped_round": (~torch.any(comm)).to(torch.int32),
        }
        if events:
            metrics["phase_events"] = events[:3]
            metrics["graph_events"] = events[2:]
        return new_state, metrics

    return graph_step
