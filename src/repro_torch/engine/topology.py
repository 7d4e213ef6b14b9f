"""Topologies: WHERE the lazy-aggregation units live and HOW their masked
deltas cross the expensive link — port of ``repro.engine.topology``.

A topology owns only batching and placement; the round itself is
``repro_torch.engine.rounds.lag_round`` for every backend:

  SimWorkers   the paper's parameter-server simulation: the units are the
               M convex workers; K rounds of ``engine.rounds.lag_round``
               on the flat buffers of a one-leaf ``(d,)`` layout
  BatchShards  the deep trainer: the units are slices of the global batch
               (rows m·B/W:(m+1)·B/W), deltas reduced by plain sum
  PodMesh      whole pods as lazy units: the cross-pod reduction runs only
               when some pod uploads (a host branch on ``any(comm)``, one
               device sync a round); a quiet round's sum is zeros of the
               delta's dtype (each part's, of a pair), on its device
  AsyncShards  bounded-staleness batch shards: worker m computes its
               gradient and evaluates its trigger at θ^{k−s_m}, the
               parameters it last saw, kept in a (τ+1)-deep ring of flat
               buffers in the lag state; staleness 0 is bitwise
               ``BatchShards``
  DeviceWorkers  one lazy worker per rank of a ``torch.distributed``
               group (``devices:D``, ``repro_torch.devrun``): the masked
               deltas cross between ranks as the policies' packed wire
               tensors, gathered and summed in worker order, bitwise the
               in-process sum
  fleet        sampled k-client cohorts over an N-client population
               (``repro_torch.fleet``)
  graph        the serverless gossip plane: W nodes with their own
               iterates, a lazy trigger per directed edge, Metropolis
               mixing (``repro_torch.graph``)

``make_topology`` takes the reference's grammar (``"pods:2"``,
``"async:4@2"``, ``"devices:2"``, ``"fleet:100000@64"``,
``"graph:9@ring"``).  The deep step functions consume ``units`` /
``place_batch`` / ``reduce_fn`` / ``extra_state`` / ``worker_views`` /
``advance_views``; the convex run ``SimWorkers.run``.  Simulated
wall-clock for an upload mask comes from ``repro_torch.netsim.cluster``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import lag
from repro_torch.core.tree import tree_map
from repro_torch.engine import rounds
from repro_torch.engine.report import RunReport
from repro_torch.engine.server import ServerOptimizer
from repro_torch.fastpath import plan as plan_lib
from repro_torch.fastpath.layout import FlatLayout, parts_of
from repro_torch.netsim import hetero as netsim_hetero


def split_batch(batch: Dict[str, torch.Tensor], num_workers: int) -> Dict:
    """Reshape every leaf's batch dim into a leading worker dim:
    ``(B, …) → (W, B/W, …)`` — worker m gets rows ``m·B/W:(m+1)·B/W``.

    M-RoPE's ``positions3`` carries a leading 3-axis, so its batch dim is
    axis 1 and the worker dim still lands in front: ``(3, B, S) → (W, 3,
    B/W, S)``.  Scalars are broadcast to ``(W,)``."""
    W = num_workers
    out = {}
    for key, x in batch.items():
        if x.dim() == 0:
            out[key] = x.expand(W)
            continue
        b_ax = 1 if "positions3" in key else 0
        B = x.shape[b_ax]
        if B % W:
            raise ValueError(f"batch dim {B} not divisible by {W} workers"
                             f" at {key!r}")
        shp = tuple(x.shape[:b_ax]) + (W, B // W) + tuple(x.shape[b_ax + 1:])
        out[key] = torch.movedim(x.reshape(shp), b_ax, 0)
    return out


# ---------------------------------------------------------------------------
# Deep backends
# ---------------------------------------------------------------------------

class Topology:
    """Placement contract the deep step functions consume.  Parameters are
    the trainer's flat ``(rows, 128)`` θ buffer."""
    name: str = "topology"
    kind: str = "deep"                   # "deep" | "convex"

    def __init__(self, num_units: Optional[int] = None):
        self.num_units = num_units

    def units(self, default: int) -> int:
        """Lazy-aggregation unit count (``num_units`` wins over the
        trainer config's worker count)."""
        return self.num_units or default

    def place_batch(self, batch: Dict, num_units: int) -> Dict:
        """Split the global batch into per-unit shards."""
        return split_batch(batch, num_units)

    def reduce_fn(self):
        """``(comm, delta) → sum_delta``, or None for the plain sum."""
        return None

    def extra_state(self, theta: Optional[torch.Tensor] = None) -> Dict:
        """Extra lag-group state this topology keeps (counters, the async
        ring — sized from the flat ``theta``)."""
        return {}

    def worker_views(self, theta: torch.Tensor, lag_state: Dict,
                     num_units: int) -> Optional[torch.Tensor]:
        """Stacked ``(W, rows, 128)`` per-worker parameter views, or None
        when every worker sees the server's current θ^k."""
        return None

    def advance_views(self, lag_state: Dict, new_theta: torch.Tensor
                      ) -> Dict:
        """Post-round lag-state updates of the view machinery (the async
        ring's push), merged into the new lag state."""
        return {}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(num_units={self.num_units})"


class BatchShards(Topology):
    """Batch-shard workers reduced by plain sum — the flat trainer."""
    name = "shards"


class PodMesh(Topology):
    """Whole pods as lazy units.  The cross-pod reduction runs only when
    some pod uploads: a quiet round's deltas are all exactly zero, so its
    sum is zeros and the trajectory is bitwise ``BatchShards``'s.  The
    reference's ``lax.cond`` becomes a host branch on ``any(comm)`` — one
    device sync a round.  ``branches`` counts the rounds each branch took.
    """
    name = "pods"

    def __init__(self, num_units: Optional[int] = None):
        super().__init__(num_units)
        self.branches = {"sum": 0, "zero": 0}

    def reduce_fn(self):
        def cond_sum(comm: torch.Tensor, delta: torch.Tensor):
            if bool(torch.any(comm)):
                self.branches["sum"] += 1
                return rounds.sum_reduce(comm, delta)
            # zeros of the summed DELTA's dtype (LAQ's payload is float32
            # whatever the parameters' dtype), on its device, part by part
            # of a pair
            self.branches["zero"] += 1
            return tree_map(lambda d: torch.zeros(
                d.shape[1:], dtype=d.dtype, device=d.device), delta)

        return cond_sum

    def extra_state(self, theta=None) -> Dict:
        dev = None if theta is None else parts_of(theta)[0].device
        return {"rounds_skipped": torch.zeros((), dtype=torch.int32,
                                              device=dev)}


class AsyncShards(Topology):
    """Bounded-staleness async LAG: worker m's gradient and trigger are
    evaluated at θ^{k−s_m}, with the staleness ramp ``s_m = ⌊m·τ/(W−1)⌋``
    from 0 (the fastest worker) to the bound τ (``staleness``).

    The lag state carries ``theta_ring``, ONE ``(τ+1, rows, 128)`` buffer
    of the last τ+1 iterates (slot i holds θ^{k−i}) at θ's dtype, shifted
    in place after every server step (slot by slot from the end: an
    overlapping copy is undefined).  A ``Parts`` θ (a tree of bfloat16
    and float32 leaves) gets a ``Parts`` of rings, one per part.  When
    ``s = arange(W)`` (W = τ+1) the ring itself is the stacked view and
    nothing is gathered; otherwise ``index_select`` copies W rows.  The
    server side — ∇, the server step, the iterate-lag history — measures
    the shared θ, so at τ = 0 the trajectory is bitwise ``BatchShards``'s.
    Memory: τ+1 parameter copies (9.9 GB for llama3.2-1b at τ = 1 in
    float32, half that in bfloat16), plus W copies for a gathered view.
    """
    name = "async"

    def __init__(self, num_units: Optional[int] = None, staleness: int = 1):
        super().__init__(num_units)
        if staleness < 0:
            raise ValueError(f"staleness bound must be >= 0, got "
                             f"{staleness}")
        self.staleness = int(staleness)

    def stale_steps(self, num_units: int) -> np.ndarray:
        """(W,) per-worker staleness: a 0→τ ramp over the worker index."""
        W, tau = num_units, self.staleness
        if W <= 1:
            return np.full((W,), tau, np.int32)
        return ((np.arange(W) * tau) // (W - 1)).astype(np.int32)

    def extra_state(self, theta=None) -> Dict:
        if theta is None:
            raise ValueError("AsyncShards.extra_state needs params to size "
                             "the staleness ring")
        depth = self.staleness + 1
        ring = tree_map(lambda t: t.unsqueeze(0).repeat(
            (depth,) + (1,) * t.dim()), theta)
        return {"theta_ring": ring}

    def worker_views(self, theta, lag_state, num_units):
        ring = lag_state["theta_ring"]
        s = self.stale_steps(num_units)
        if len(s) == parts_of(ring)[0].shape[0] \
                and np.array_equal(s, np.arange(len(s))):
            return ring
        idx = torch.as_tensor(s, dtype=torch.long,
                              device=parts_of(ring)[0].device)
        return tree_map(lambda r: r.index_select(0, idx), ring)

    def advance_views(self, lag_state, new_theta) -> Dict:
        ring = lag_state["theta_ring"]
        for r, t in zip(parts_of(ring), parts_of(new_theta)):
            for i in range(r.shape[0] - 1, 0, -1):
                r[i].copy_(r[i - 1])
            r[0].copy_(t)
        return {"theta_ring": ring}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"AsyncShards(num_units={self.num_units}, "
                f"staleness={self.staleness})")


class DeviceWorkers(Topology):
    """One lazy worker per RANK — the ``repro_torch.devrun`` execution
    plane.

    Same round math as ``BatchShards`` — masks, θ, ĝ and the counters
    bitwise, where each rank's backward pass is bitwise the in-process
    worker's — but the workers are the ranks of an initialised
    ``torch.distributed`` group of D: each runs
    ``engine.rounds.policy_rounds`` on its own shard at local W = 1, and
    the masked deltas cross between ranks as the policy's PACKED wire
    tensors (``CommPolicy.wire_pack``), gathered and summed in worker
    order.  The step builders live in ``repro_torch.devrun.runner``;
    without a group of D ranks they raise (the reference falls back to its
    vmapped trainer there).
    """
    name = "devices"

    def num_devices(self, default: Optional[int] = None) -> int:
        """The worker/rank count: ``devices:D`` pins D; bare ``devices``
        takes ``default``, else the initialised group's world size, else
        the visible cards."""
        if self.num_units:
            return self.num_units
        if default:
            return default
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return torch.cuda.device_count()

    def available(self, default: Optional[int] = None) -> bool:
        """True inside an initialised group of exactly D ranks."""
        import torch.distributed as dist
        return dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == self.num_devices(default)

    def device_mesh(self, default: Optional[int] = None,
                    device_type: str = "cuda"):
        """1-D ``("workers",)`` mesh over the group's D ranks."""
        from repro_torch.launch.mesh import make_mesh
        return make_mesh((self.num_devices(default),), ("workers",),
                         device_type)


# ---------------------------------------------------------------------------
# Convex backend
# ---------------------------------------------------------------------------

class SimWorkers(Topology):
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
    kind = "convex"

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

def _make_fleet(population=None, cohort=None, **kw):
    """Lazy ``repro_torch.fleet`` factory: the fleet imports the engine's
    round seam, so importing it at module scope would close a cycle."""
    from repro_torch.fleet.topology import FleetTopology
    return FleetTopology(population=population, cohort=cohort, **kw)


def _make_graph(num_nodes=None, family=None, **kw):
    """Lazy ``repro_torch.graph`` factory (the fleet's cycle-avoidance):
    the gossip plane consumes the engine's round seam."""
    from repro_torch.graph.topology import GraphTopology
    return GraphTopology(num_nodes=num_nodes, family=family, **kw)


TOPOLOGIES = {
    "sim": SimWorkers,
    "shards": BatchShards,
    "pods": PodMesh,
    "async": AsyncShards,
    "devices": DeviceWorkers,
    "fleet": _make_fleet,
    "graph": _make_graph,
}

_FLEET_GRAMMAR = ("fleet needs BOTH a population and a cohort size — "
                  "'fleet:<population>@<cohort>', e.g. 'fleet:100000@64' "
                  "(sample 64 of 100000 clients per round)")


def make_topology(spec) -> Topology:
    """Build a ``Topology`` from a spec string (or pass one through).

    The reference's grammar: ``<name>[:<units>][@<staleness>]`` —
    ``"sim"``, ``"shards"``, ``"pods:2"`` (two lazy pods),
    ``"async:4@2"`` (four bounded-staleness workers, the slowest 2 rounds
    behind; ``"async"`` alone has staleness 1), ``"devices:2"`` (one
    worker per rank of a group of two: ``repro_torch.devrun``),
    ``"fleet:<population>@<cohort>"`` (``"fleet:100000@64"`` samples a
    64-client cohort per round from 10⁵ clients) and the gossip plane
    ``"graph:<nodes>@<family>"`` (``"graph:9@ring"``,
    ``"graph:12@torus:3x4"``, ``"graph:9@complete"``,
    ``"graph:16@expander:4"``, ``"graph:16@smallworld:4@0.2"``: the family
    may itself carry ``:``/``@`` arguments), with the reference's
    validation messages.
    """
    if isinstance(spec, Topology):
        return spec
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"topology spec must be a non-empty string or a "
                         f"Topology, got {spec!r}")
    head, sep_at, stale_s = spec.partition("@")
    name, sep, units = head.partition(":")
    name = name.strip()
    if name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {spec!r}; known: "
                         f"{tuple(TOPOLOGIES)} (optionally ':<units>', "
                         f"e.g. 'pods:2'; async also takes '@<staleness>'; "
                         f"fleet needs 'fleet:<population>@<cohort>'; "
                         f"graph needs 'graph:<nodes>@<family>')")
    if name == "graph":
        # partition("@") split at the FIRST @, so the family half may
        # itself contain '@' ('smallworld:4@0.2')
        from repro_torch.graph.spec import GRAPH_GRAMMAR
        if not sep or not sep_at:
            raise ValueError(f"bad topology spec {spec!r}: graph needs "
                             f"BOTH a node count and a family — "
                             f"{GRAPH_GRAMMAR}")
        try:
            n = int(units)
        except ValueError:
            raise ValueError(
                f"bad topology spec {spec!r}: ':{units}' is not an integer "
                f"node count — {GRAPH_GRAMMAR}") from None
        return TOPOLOGIES["graph"](num_nodes=n, family=stale_s)
    if name == "fleet":
        if not sep or not sep_at:
            raise ValueError(f"bad topology spec {spec!r}: "
                             f"{_FLEET_GRAMMAR}")
        try:
            population = int(units)
        except ValueError:
            raise ValueError(
                f"bad topology spec {spec!r}: ':{units}' is not an integer "
                f"population — {_FLEET_GRAMMAR}") from None
        try:
            cohort = int(stale_s)
        except ValueError:
            raise ValueError(
                f"bad topology spec {spec!r}: '@{stale_s}' is not an "
                f"integer cohort size — {_FLEET_GRAMMAR}") from None
        if population < 1:
            raise ValueError(f"bad topology spec {spec!r}: population must "
                             f"be >= 1 — {_FLEET_GRAMMAR}")
        if not 1 <= cohort <= population:
            raise ValueError(f"bad topology spec {spec!r}: cohort must be "
                             f"in [1, population={population}] — "
                             f"{_FLEET_GRAMMAR}")
        return TOPOLOGIES["fleet"](population=population, cohort=cohort)
    kwargs = {}
    if sep_at:
        if name != "async":
            raise ValueError(
                f"bad topology spec {spec!r}: only 'async', 'fleet' and "
                f"'graph' take an '@' suffix (e.g. 'async:4@2', "
                f"'fleet:100000@64', 'graph:9@ring')")
        try:
            kwargs["staleness"] = int(stale_s)
        except ValueError:
            raise ValueError(
                f"bad topology spec {spec!r}: '@{stale_s}' is not an "
                f"integer staleness bound (want e.g. 'async:4@2')") from None
        if kwargs["staleness"] < 0:
            raise ValueError(f"bad topology spec {spec!r}: staleness must "
                             f"be >= 0")
    n = None
    if sep:
        try:
            n = int(units)
        except ValueError:
            raise ValueError(
                f"bad topology spec {spec!r}: ':{units}' is not an integer "
                f"unit count (want e.g. 'pods:2')") from None
        if n < 1:
            raise ValueError(f"bad topology spec {spec!r}: unit count must "
                             f"be >= 1")
    return TOPOLOGIES[name](num_units=n, **kwargs)
