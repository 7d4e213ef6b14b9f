"""``FleetTopology`` — sampled-cohort rounds over an N-client population —
port of ``repro.fleet.topology``.

``fleet:N@k`` (``repro_torch.engine.make_topology``): N virtual clients, of
which a k-cohort is sampled every round.  The lazy units the round sees
are the k COHORT SLOTS (``units()`` is k: batch placement, the policy and
the delta reduction are O(k)); the population state (the compact mirrors
and the churn / age / innovation vectors) is the only thing sized by N.

Dials beyond the spec string: ``churn`` (per-round leave probability;
0.0 is structurally churn-free), ``selection`` ("uniform" or
"innovation"), and ``draw`` — an injectable ``draw(step) → (gumbel (N,),
uniforms (N,) or None)`` replacing the default host draws
(``sampling.host_draws``).

α stays normalised by the POPULATION (``LAGConfig.num_workers = N``): ∇^k
sums all N stale gradients, so at k = N the fleet is the sync trainer.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.engine.topology import Topology
from repro_torch.fleet.selection import SELECTION_RULES


class FleetTopology(Topology):
    name = "fleet"
    kind = "deep"            # deep step native; convex via fleet.run_convex

    def __init__(self, population: int, cohort: int, churn: float = 0.0,
                 selection: str = "uniform",
                 draw: Optional[Callable] = None):
        if population < 1:
            raise ValueError(f"fleet population must be >= 1, got "
                             f"{population}")
        if not 1 <= cohort <= population:
            raise ValueError(f"fleet cohort must be in [1, population="
                             f"{population}], got {cohort}")
        if not 0.0 <= churn <= 1.0:
            raise ValueError(f"fleet churn must be in [0, 1], got {churn}")
        if selection not in SELECTION_RULES:
            raise ValueError(f"unknown fleet selection rule {selection!r}; "
                             f"known: {tuple(SELECTION_RULES)}")
        super().__init__(num_units=int(cohort))
        self.population = int(population)
        self.cohort = int(cohort)
        self.churn = float(churn)
        self.selection = selection
        self.draw = draw

    def units(self, default: int) -> int:
        return self.cohort

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FleetTopology(population={self.population}, "
                f"cohort={self.cohort}, churn={self.churn}, "
                f"selection={self.selection!r})")
