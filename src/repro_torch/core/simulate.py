"""Parameter-server simulation driver — port of ``repro.core.simulate``,
a thin shim over the engine.

:func:`run` forwards to :class:`repro_torch.engine.Experiment`, whose
convex path (``repro_torch.engine.topology.SimWorkers.run``) drives the
shared round ``repro_torch.engine.rounds.lag_round`` for K rounds.  It
runs the paper's Sec.-4 experiments: full-batch distributed optimization
of a ``repro_torch.core.convex.Problem`` under one of

  gd       — batch gradient descent, all M workers upload each round (eq. 2)
  lag-wk   — LAG with the worker-side trigger (15a)
  lag-ps   — LAG with the server-side trigger (15b)
  laq      — LAG + b-bit quantized uploads with error feedback (LAQ)
  lasg-wk  — the stochastic-trigger variant (LASG-WK)
  cyc-iag  — cyclic incremental aggregated gradient (one worker per round)
  num-iag  — IAG with worker m sampled ∝ L_m (one worker per round)

plus any spec ``repro_torch.comm.make_policy`` parses (``"laq@8"``,
``"cyc-laq@8"``, …).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.convex import Problem

ALGOS = ("gd", "lag-wk", "lag-ps", "laq", "lasg-wk", "cyc-iag", "num-iag")
# algos whose round is a CommPolicy trigger (vs a schedule-driven mask)
POLICY_ALGOS = ("gd", "lag-wk", "lag-ps", "laq", "lasg-wk")


def run(problem: Problem, algo: str, *, K: int = 2000,
        D: int = 10, xi: Optional[float] = None, alpha: Optional[float] = None,
        seed: int = 0, theta0=None, opt_loss: Optional[float] = None,
        l1: float = 0.0, policy=None, bits: int = 4, server=None,
        rhs_floor: float = 0.0, fastpath: Optional[str] = None):
    """Simulate ``K`` rounds of ``algo`` on ``problem`` → ``RunReport``.

    Defaults follow the paper: α = 1/L for GD/LAG/LAQ/LASG and 1/(M·L) for
    the IAG variants; ξ = 1/D for the worker-side triggers and 10/D for
    LAG-PS; D = 10.  ``policy`` overrides the algo's policy (any
    ``CommPolicy``); ``bits`` sets LAQ's width; ``l1 > 0`` selects the
    prox-l1 server (proximal LAG; the loss becomes L(θ) + l1·‖θ‖₁);
    ``server`` any ``repro_torch.engine.server`` spec; ``rhs_floor``
    floors the trigger RHS.  ``fastpath`` as in ``Experiment``: the plane
    follows the problem's dtype.
    """
    from repro_torch.engine import Experiment   # function-level: core ↔ engine

    return Experiment(problem=problem, algo=algo, steps=K, D=D, xi=xi,
                      alpha=alpha, seed=seed, theta0=theta0,
                      opt_loss=opt_loss, l1=l1, policy=policy, bits=bits,
                      server=server, rhs_floor=rhs_floor,
                      fastpath=fastpath).run()
