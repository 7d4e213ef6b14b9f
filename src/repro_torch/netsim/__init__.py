"""``repro_torch.netsim`` — the heterogeneity dial and the network cost
model (port of ``repro.netsim``).

  data heterogeneity   ``netsim.hetero`` — convex problems with a
                       sweepable smoothness-spread dial ``h``; realized
                       L_m spread and heterogeneity score reported in
                       ``RunReport.extras``; the deep shards' token-noise
                       dial (``hetero_inputs``)
  network cost         ``netsim.cluster`` — per-link latency/bandwidth,
                       straggler distributions, an event-driven round
                       pricer that turns any run's upload mask into
                       simulated wall-clock (``make_cluster(
                       "hetero:9@10ms/1Gbps")``)

Both plug into the engine's front door:

    from repro_torch.engine import Experiment
    from repro_torch.netsim import hetero_problem

    prob = hetero_problem("linreg", h=0.8, seed=0, device="cpu")
    r = Experiment(problem=prob, algo="lag-wk", steps=1000,
                   cluster="hetero:9@10ms/1Gbps").run()
    r.extras["L_m_spread"], r.seconds_to(1e-6), r.wall_seconds
"""
from repro_torch.netsim.cluster import (CLUSTERS, Cluster, Link, make_cluster,
                                        price_cohort_mask, price_edge_mask,
                                        price_edge_report, price_fleet_report,
                                        price_mask, price_report)
from repro_torch.netsim.hetero import (hetero_inputs, hetero_L_targets,
                                       hetero_problem, hetero_score,
                                       realized_spread, shard_noise_levels)

__all__ = [
    "Cluster", "Link", "CLUSTERS", "make_cluster", "price_mask",
    "price_report", "price_cohort_mask", "price_fleet_report",
    "price_edge_mask", "price_edge_report",
    "hetero_problem", "hetero_L_targets", "hetero_score", "realized_spread",
    "shard_noise_levels", "hetero_inputs",
]
