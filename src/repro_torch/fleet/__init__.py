"""``repro_torch.fleet`` — sampled-cohort rounds over huge populations
(port of ``repro.fleet``).

A fleet deployment polls a small k-cohort per round from N ≫ k churning
clients.  Per-client mirrors live in compact ``(N, packed_cols)`` buffers
(memory in N only for those); each round gathers the cohort into plane
buffers, runs it through the unchanged ``engine.rounds.policy_rounds``
seam (every ``CommPolicy`` composes) and scatters the advanced state back.

Spec: ``Experiment(topology="fleet:100000@64")``; churn, the selection
rule and injected draws are ``FleetTopology`` constructor dials.
"""
from repro_torch.fleet.population import INNOV_INIT, MIRROR_PREFIX, Population
from repro_torch.fleet.problems import fleet_problem
from repro_torch.fleet.rounds import (fleet_round, init_fleet_state,
                                      make_fleet_step, run_convex,
                                      sample_cohort)
from repro_torch.fleet.sampling import (REJOIN, churn_step, gumbel_top_k,
                                        host_draws)
from repro_torch.fleet.selection import SELECTION_RULES, make_selection
from repro_torch.fleet.topology import FleetTopology

__all__ = [
    "FleetTopology", "Population", "INNOV_INIT", "MIRROR_PREFIX",
    "fleet_problem", "fleet_round", "init_fleet_state", "make_fleet_step",
    "run_convex", "sample_cohort", "churn_step", "gumbel_top_k", "REJOIN",
    "SELECTION_RULES", "make_selection", "host_draws",
]
