"""The distributed LAG trainer (port of ``repro.dist``).

  lag_trainer   TrainerConfig / init_state / make_train_step — the deep
                consumer of ``engine.rounds`` (``mesh=``: the row-sharded
                trainer of ``row_shards``)
  sharding      spec_for + tree/batch specs (the reference's rules,
                verbatim) and their DTensor shardings on a DeviceMesh
  row_shards    the trainer on a host mesh: the LAG state row-sharded over
                the data ranks, θ replicated
  pod_lag       pod-level LAG where a quiet round skips the reduction
  collectives   the collective wrappers and ``collective_bytes`` (counted
                at the call; the reference parses compiled HLO,
                ``repro.dist.hlo_analysis``)
"""
from repro_torch.dist import collectives, sharding
from repro_torch.dist.collectives import (CollectiveStats, collective_bytes,
                                          logical_upload_bytes,
                                          policy_traffic_summary)
from repro_torch.dist.sharding import (batch_shardings, batch_specs, spec_for,
                                       tree_shardings, tree_specs)

__all__ = ["collectives", "collective_bytes", "CollectiveStats",
           "logical_upload_bytes", "policy_traffic_summary", "sharding",
           "spec_for", "tree_specs", "tree_shardings", "batch_specs",
           "batch_shardings"]
