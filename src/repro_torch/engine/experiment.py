"""``Experiment`` — the one front door: any policy × any server × any
topology as a config — port of ``repro.engine.experiment``.

    from repro_torch.core.convex import synthetic
    from repro_torch.engine import Experiment

    # the paper's Fig.-3 run, in float64 on the card
    prob = synthetic("linreg", dtype=torch.float64)
    Experiment(problem=prob, algo="lag-wk", steps=3000).run()

    # netsim: priced on a simulated network — the report gains
    # seconds_to(eps) / wall_seconds
    Experiment(problem=hetero_problem("linreg", h=0.8), algo="lag-wk",
               steps=1000, cluster="hetero:9@10ms/1Gbps").run()

    # the deep trainer: two lazy pods, bounded-staleness async LAG, a
    # sampled-cohort fleet (reduced=False: full width on the card)
    Experiment(model="llama3.2-1b", algo="lag-wk", topology="pods:2",
               steps=10).run()
    Experiment(model="llama3.2-1b", topology="async:4@2", steps=20).run()
    Experiment(model="llama3.2-1b", topology="fleet:100@8", steps=20).run()

    # the convex fleet: k of N clients a round
    Experiment(problem=fleet_problem(num_clients=10_000), steps=300,
               topology="fleet:10000@625").run()

    # the serverless gossip plane: lazy triggers per directed edge, convex
    # or deep (then the mask is (K, E) and cluster= prices each edge)
    Experiment(problem=prob, algo="lag-wk", steps=400,
               topology="graph:9@ring", cluster="hetero:18@10ms/1Gbps").run()
    Experiment(model="llama3.2-1b", topology="graph:4@ring", steps=4).run()

Every run returns a ``RunReport`` with the same trajectory fields whether
the units are convex workers, batch shards, pods or cohort slots.  Convex
defaults follow the paper: α = 1/L (1/(M·L) for the IAG schedules), ξ =
1/D (10/D for LAG-PS); a gossip graph takes α = 1/(M·max L_m), the
diffusion-stable default.  The comm plane follows the problem's dtype (a
float64 problem gets a policy without a plan, the plain route; ``"on"``
then raises).  Deep defaults follow ``repro_torch.dist.TrainerConfig``;
deep runs go to ``device`` (the card unless the caller asks for the CPU).
``topology="devices:D"`` runs inside an initialised ``torch.distributed``
group of D ranks, one worker a rank (``repro_torch.devrun``; every rank
calls ``run()`` and gets the same report); outside one it raises, naming
the launcher.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import comm as comm_lib
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves
from repro_torch.engine.report import RunReport
from repro_torch.engine.server import ProxL1Server, make_server
from repro_torch.engine.topology import SimWorkers, make_topology
from repro_torch.fastpath.plan import make_plan
from repro_torch.netsim import cluster as netsim_cluster


@dataclasses.dataclass
class Experiment:
    """A declarative experiment spec.  Exactly one of ``problem`` (a
    ``repro_torch.core.convex.Problem``) or ``model`` (a ``ModelConfig`` or
    an arch name for ``repro_torch.configs.get_config``) selects the
    workload; ``algo``/``server``/``topology`` are spec strings (or
    objects) for the three composable axes."""
    # workload (exactly one)
    problem: Optional[Any] = None
    model: Optional[Any] = None          # ModelConfig | arch-name str

    # the three axes
    algo: str = "lag-wk"                 # policy spec → comm.make_policy
    server: Optional[Any] = None         # spec/object; None → paper default
    topology: Optional[Any] = None       # spec/object; None → sim | shards

    # shared knobs
    steps: int = 500                     # rounds [K]
    D: int = 10                          # iterate-lag window [D]
    xi: Optional[float] = None           # trigger weight [ξ]; None → default
    seed: int = 0
    bits: int = 4                        # LAQ width (spec '@b' overrides)
    l1: float = 0.0                      # sugar for server="prox-l1@<l1>"
    rhs_floor: float = 0.0               # trigger-RHS floor (f32 quirk knob)
    fastpath: Optional[str] = None       # the comm plane: None → "auto"
    #   for a float32 problem and no plan for a float64 one; "on" forces
    #   the plane (plain kernel versions on CPU tensors; a float64 problem
    #   raises).  Ignored when policy= is an object override.
    policy: Optional[Any] = None         # CommPolicy object override
    cluster: Optional[Any] = None        # repro_torch.netsim cluster
    #   spec/object: the run is priced through the event-driven cost model
    #   and the report gains round_seconds / wall_seconds / seconds_to(eps)

    # convex knobs
    alpha: Optional[float] = None        # stepsize; None → 1/L (paper)
    theta0: Optional[Any] = None
    opt_loss: Optional[float] = None

    # deep knobs
    workers: int = 4
    lr: float = 0.05
    batch: int = 8
    seq: int = 64
    hetero: Optional[float] = None       # deep heterogeneity dial h ∈ [0, 1]
    #   for the worker shards (repro_torch.netsim.hetero); None → the full
    #   ramp (h = 1).  Convex heterogeneity is a property of the Problem
    fixed_batch: bool = True             # True: one batch every round (the
    #   paper's full-batch regime); False: a fresh batch per step
    reduced: bool = True                 # CPU-sized arch when model is a str
    device: Any = "cuda"                 # deep runs: "cuda" (raises without
    #   a GPU) or "cpu"

    def run(self) -> RunReport:
        if (self.problem is None) == (self.model is None):
            raise ValueError("Experiment needs exactly one of problem= "
                             "(convex) or model= (deep)")
        if self.problem is not None:
            if self.hetero is not None:
                raise ValueError(
                    "hetero= is the DEEP shard dial; convex heterogeneity "
                    "is a property of the Problem — build one with "
                    "repro_torch.netsim.hetero_problem(h=...)")
            # the broadcast moves DENSE params even when uploads are
            # quantized, so it is sized separately from bytes_per_upload
            report, dense = self._run_convex(), float(
                self.problem.dim * self.problem.X.element_size())
        else:
            report, dense = self._run_deep()
        if self.cluster is not None:
            if "cohort_ids" in report.extras:
                # fleet runs: price only the k sampled uplinks per round
                netsim_cluster.price_fleet_report(report, self.cluster,
                                                  dense_bytes=dense)
            elif "edge_dst" in report.extras:
                # graph runs: the (K, E) mask is per DIRECTED edge — one
                # link draw per edge, in-edges drain per destination node
                netsim_cluster.price_edge_report(report, self.cluster,
                                                 dense_bytes=dense)
            else:
                netsim_cluster.price_report(report, self.cluster,
                                            dense_bytes=dense)
        return report

    # -- resolution ---------------------------------------------------------

    def _resolve_server(self, default: str = "sgd"):
        if self.l1 > 0.0:
            # l1 is sugar for the prox-l1 server — refuse to silently
            # drop it when another server source also claims the slot
            if self.server is not None:
                raise ValueError(
                    f"conflicting server specs: l1={self.l1} selects "
                    f"'prox-l1' but server={self.server!r} was also given "
                    f"— pass one of them (e.g. server='prox-l1@{self.l1}')")
            if self.algo in ("adam", "lag-adam"):
                raise ValueError(
                    f"conflicting server specs: algo={self.algo!r} selects "
                    f"the 'adam' server but l1={self.l1} selects 'prox-l1' "
                    f"— spell the trigger explicitly (algo='lag-wk' or "
                    f"'gd') plus the server you want")
            return ProxL1Server(self.l1)
        if self.server is not None:
            return make_server(self.server)
        if self.algo in ("adam", "lag-adam"):
            return make_server("adam")
        return make_server(default)

    def _plane_mode(self) -> Optional[str]:
        """The policy's comm-plane mode, decided by the problem's dtype: no
        plan for float64 (unless forced, which then raises in the round),
        the caller's mode (default "auto") for float32 and the deep
        models."""
        mode = self.fastpath or "auto"
        make_plan(mode)                              # validate the mode
        if self.problem is not None and self.problem.dtype == torch.float64 \
                and mode != "on":
            return None
        return mode

    def _resolve_policy(self, probs=None):
        if self.policy is not None:
            policy = self.policy
            # the schedule comes from the ALGO, the policy= override only
            # swaps the payload: a scheduled algo wraps it in its schedule
            prefix = self.algo.split("-", 1)[0]
            if prefix in comm_lib.SCHEDULES and not isinstance(
                    policy, comm_lib.ScheduledPolicy):
                policy = comm_lib.ScheduledPolicy(
                    policy, comm_lib.SCHEDULES[prefix](probs))
            return policy
        return comm_lib.make_policy(self.algo, bits=self.bits, probs=probs,
                                    fastpath=self._plane_mode())

    # -- convex -------------------------------------------------------------

    def _run_convex(self) -> RunReport:
        prob = self.problem
        M = prob.num_workers
        topo = make_topology(self.topology or "sim")
        fleet = topo.name == "fleet"
        graph = topo.name == "graph"
        if not (fleet or graph or isinstance(topo, SimWorkers)):
            raise ValueError(
                f"convex problems run on the 'sim' topology, got "
                f"{topo.name!r} (deep topologies need model=)")
        alpha = self.alpha
        if alpha is None:
            # paper defaults: α = 1/L, except 1/(M·L) for the one-upload-
            # per-round IAG schedules.  A gossip graph takes the diffusion-
            # stable default: the adapt applies α·W·∇L_i(θ_i) locally, which
            # is stable only while α·W < 2/max(L_m)
            if graph:
                alpha = 1.0 / (M * float(torch.max(prob.L_m)))
            elif "iag" in self.algo:
                alpha = 1.0 / (M * prob.L)
            else:
                alpha = 1.0 / prob.L
        xi = self.xi
        if xi is None:
            xi = (10.0 / self.D) if self.algo == "lag-ps" else (1.0 / self.D)
        cfg = lag.LAGConfig(
            num_workers=M, alpha=float(alpha), D=self.D, xi=float(xi),
            rule="ps" if "lag-ps" in self.algo else "wk",
            rhs_floor=self.rhs_floor)
        # num-IAG samples workers ∝ L_m (paper Sec. 4); on a graph the lazy
        # units are the E directed edges, each weighted by its SOURCE
        # node's L_m.  The draw is made on the host
        probs = None
        if self.algo.startswith("num-"):
            L_m = prob.L_m.detach().cpu().double()
            if graph:
                L_m = L_m[torch.as_tensor(topo.spec.edge_src,
                                          dtype=torch.long)]
            probs = L_m / torch.sum(L_m)
        policy = self._resolve_policy(probs=probs)
        server = self._resolve_server()
        if fleet or graph:
            # cohort-sampled rounds over an N-client population, or the
            # serverless gossip rounds (function-level imports: both
            # packages consume the engine)
            if fleet:
                from repro_torch import fleet as lib
            else:
                from repro_torch import graph as lib
            report = lib.run_convex(prob, policy, server, cfg, topo,
                                    K=self.steps, seed=self.seed,
                                    theta0=self.theta0,
                                    opt_loss=self.opt_loss)
        else:
            report = topo.run(prob, policy, server, cfg, K=self.steps,
                              seed=self.seed, theta0=self.theta0,
                              opt_loss=self.opt_loss)
        report.algo = self.algo
        return report

    # -- deep ---------------------------------------------------------------

    def _run_deep(self):
        """(report, dense bytes of one parameter copy): ``steps`` rounds of
        the trainer (``shards``, ``pods``, ``async``), the device plane's
        step (``devices``), the fleet step or the graph step."""
        # function-level: repro_torch.dist and repro_torch.fleet consume
        # the engine; importing them at module scope would close a cycle
        from repro_torch.configs import get_config
        from repro_torch.data import TokenStream, make_heterogeneous_inputs
        from repro_torch.device import resolve_device
        from repro_torch.dist import lag_trainer
        from repro_torch.models.common import ModelConfig

        cfg = self.model
        if isinstance(cfg, str):
            cfg = get_config(cfg)
            if self.reduced:
                cfg = cfg.reduced()
        if not isinstance(cfg, ModelConfig):
            raise ValueError(f"model= must be a ModelConfig or an arch "
                             f"name, got {type(self.model).__name__}")
        topo = make_topology(self.topology or "shards")
        if topo.kind != "deep":
            raise ValueError("deep models run on 'shards' or 'pods:N' "
                             "topologies, not 'sim' (sim needs problem=)")
        device = resolve_device(self.device)
        W = topo.units(self.workers)
        tcfg = lag_trainer.TrainerConfig(
            algo=self.algo, num_workers=W, lr=self.lr, D=self.D,
            xi=self.xi if self.xi is not None else 0.1,
            laq_bits=self.bits, rhs_floor=self.rhs_floor,
            fastpath=self._plane_mode())
        policy = self._resolve_policy()
        server = self._resolve_server()
        fleet = topo.name == "fleet"
        graph = topo.name == "graph"
        if topo.name == "devices":
            # one worker per rank of the caller's group: the packed wire
            # gathered between ranks (function-level import: the device
            # plane consumes the engine, like the trainer)
            from repro_torch import devrun
            state = devrun.init_device_state(
                cfg, tcfg, device=device, seed=self.seed, policy=policy,
                server=server, topology=topo)
            device = state["theta"].device
            step_fn = devrun.make_device_step(
                cfg, tcfg, policy=policy, server=server, topology=topo,
                schedule_seed=self.seed)
        elif fleet:
            from repro_torch import fleet as fleet_lib
            state = fleet_lib.init_fleet_state(
                cfg, tcfg, topo, device=device, seed=self.seed,
                policy=policy, server=server)
            step_fn = fleet_lib.make_fleet_step(
                cfg, tcfg, topo, policy=policy, server=server,
                schedule_seed=self.seed)
        elif graph:
            # stacked per-node iterates, per-edge mirrors
            from repro_torch import graph as graph_lib
            state = graph_lib.init_graph_state(
                cfg, tcfg, topo, device=device, seed=self.seed,
                policy=policy, server=server)
            step_fn = graph_lib.make_graph_step(
                cfg, tcfg, topo, policy=policy, server=server,
                schedule_seed=self.seed)
        else:
            state = lag_trainer.init_state(
                cfg, tcfg, device=device, seed=self.seed, policy=policy,
                server=server, topology=topo)
            step_fn = lag_trainer.make_train_step(
                cfg, tcfg, policy=policy, server=server, topology=topo,
                schedule_seed=self.seed)
        stream = TokenStream(vocab=cfg.vocab_size, seed=self.seed)

        losses, masks, underflow, cohorts, cohort_comm = [], [], [], [], []
        batch = None
        h = 1.0 if self.hetero is None else self.hetero
        for k in range(self.steps):
            if batch is None or not self.fixed_batch:
                batch = make_heterogeneous_inputs(
                    cfg, stream, k, W, self.batch, self.seq,
                    fixed=self.fixed_batch, h=h, device=device)
            state, m = step_fn(state, batch)
            losses.append(m["loss"])
            masks.append(m["comm_mask"])
            underflow.append(m["trigger_rhs_underflow"])
            if fleet:
                cohorts.append(m["cohort_ids"])
                cohort_comm.append(m["cohort_comm"])
            del m
        extras = {"trigger_rhs_underflow_rounds":
                  int(torch.stack(underflow).sum())}
        if fleet:
            extras["cohort_ids"] = torch.stack(cohorts).cpu().numpy()
            extras["cohort_comm"] = torch.stack(cohort_comm).cpu().numpy()
            extras["population"] = topo.population
            extras["cohort"] = topo.cohort
        if self.hetero is not None:
            extras["hetero_dial"] = float(self.hetero)
        if "rounds_skipped" in state["lag"]:
            extras["rounds_skipped"] = int(state["lag"]["rounds_skipped"])
        if graph:
            # the stacked (W, …) node iterates: ONE node's iterate moves
            # per edge, so the bytes are sized from node 0's slice; the
            # edge map feeds the pricer
            from repro_torch.graph import node_params
            params = node_params(state, cfg)
            extras.update(edge_src=topo.spec.edge_src,
                          edge_dst=topo.spec.edge_dst,
                          graph_family=topo.family,
                          num_nodes=topo.num_nodes)
        else:
            params = lag_trainer.params_of(state, cfg)
        dense_bytes = float(sum(l.numel() * l.element_size()
                                for l in tree_leaves(params)))
        report = RunReport(
            algo=self.algo,
            losses=torch.stack(losses).cpu().numpy(),
            comm_mask=torch.stack(masks).cpu().numpy(), opt_loss=0.0,
            bytes_per_upload=policy.wire_bytes(params), server=server.name,
            topology=topo.name, extras=extras)
        return report, dense_bytes
