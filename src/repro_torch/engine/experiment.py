"""``Experiment`` — the front door of the convex runs — port of the convex
dispatch of ``repro.engine.experiment``.

    from repro_torch.core.convex import synthetic
    from repro_torch.engine import Experiment

    # the paper's Fig.-3 run, in float64 on the card
    prob = synthetic("linreg", dtype=torch.float64)
    Experiment(problem=prob, algo="lag-wk", steps=3000).run()

    # LAG-Adam in the convex sim
    Experiment(problem=prob, algo="lag-wk", server="adam", steps=200).run()

    # netsim: priced on a simulated network — the report gains
    # seconds_to(eps) / wall_seconds
    Experiment(problem=hetero_problem("linreg", h=0.8), algo="lag-wk",
               steps=1000, cluster="hetero:9@10ms/1Gbps").run()

Convex defaults follow the paper: α = 1/L (1/(M·L) for the IAG
schedules), ξ = 1/D (10/D for LAG-PS).  The comm plane follows the
problem's dtype: a float64 problem gets a policy without a plan (the plain
route; the float32 plane cannot serve it), unless ``fastpath="on"`` forces
the plane, which then raises; a float32 problem gets the caller's mode
(``None`` → ``"auto"``: the plane on CUDA tensors).  The deep dispatch
(``model=``) is not ported yet: the port's trainer is
``repro_torch.launch.train``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import comm as comm_lib
from repro_torch.core import lag
from repro_torch.engine.report import RunReport
from repro_torch.engine.server import ProxL1Server, make_server
from repro_torch.engine.topology import SimWorkers, make_topology
from repro_torch.fastpath.plan import make_plan
from repro_torch.netsim import cluster as netsim_cluster


@dataclasses.dataclass
class Experiment:
    """A declarative experiment spec: a ``repro_torch.core.convex.Problem``
    (``problem``) and spec strings (or objects) for the policy
    (``algo``), the server step and the topology."""
    # workload (exactly one)
    problem: Optional[Any] = None
    model: Optional[Any] = None          # not ported yet: raises

    # the three axes
    algo: str = "lag-wk"                 # policy spec → comm.make_policy
    server: Optional[Any] = None         # spec/object; None → paper default
    topology: Optional[Any] = None       # spec/object; None → sim

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

    def run(self) -> RunReport:
        if (self.problem is None) == (self.model is None):
            raise ValueError("Experiment needs exactly one of problem= "
                             "(convex) or model= (deep)")
        if self.model is not None:
            raise NotImplementedError(
                "Experiment(model=...) is not ported yet, use "
                "repro_torch.launch.train (python -m "
                "repro_torch.launch.train)")
        report = self._run_convex()
        if self.cluster is not None:
            # the broadcast moves DENSE params even when uploads are
            # quantized, so it is sized separately from bytes_per_upload
            dense = float(self.problem.dim
                          * self.problem.X.element_size())
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
        the caller's mode (default "auto") for float32."""
        mode = self.fastpath or "auto"
        make_plan(mode)                              # validate the mode
        if self.problem.dtype == torch.float64 and mode != "on":
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
        if not isinstance(topo, SimWorkers):
            raise ValueError(
                f"convex problems run on the 'sim' topology, got "
                f"{topo.name!r} (deep topologies need model=)")
        alpha = self.alpha
        if alpha is None:
            # paper defaults: α = 1/L, except 1/(M·L) for the one-upload-
            # per-round IAG schedules
            alpha = 1.0 / (M * prob.L) if "iag" in self.algo \
                else 1.0 / prob.L
        xi = self.xi
        if xi is None:
            xi = (10.0 / self.D) if self.algo == "lag-ps" else (1.0 / self.D)
        cfg = lag.LAGConfig(
            num_workers=M, alpha=float(alpha), D=self.D, xi=float(xi),
            rule="ps" if "lag-ps" in self.algo else "wk",
            rhs_floor=self.rhs_floor)
        # num-IAG samples workers ∝ L_m (paper Sec. 4); the draw is made on
        # the host
        probs = None
        if self.algo.startswith("num-"):
            L_m = prob.L_m.detach().cpu().double()
            probs = L_m / torch.sum(L_m)
        policy = self._resolve_policy(probs=probs)
        server = self._resolve_server()
        report = topo.run(prob, policy, server, cfg, K=self.steps,
                          seed=self.seed, theta0=self.theta0,
                          opt_loss=self.opt_loss)
        report.algo = self.algo
        return report
