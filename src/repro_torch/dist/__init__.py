"""The distributed LAG trainer (port of ``repro.dist``).

  lag_trainer   TrainerConfig / init_state / make_train_step — the deep
                consumer of ``engine.rounds``
  pod_lag       pod-level LAG where a quiet round skips the reduction
  collectives   the device plane's collective wrapper and
                ``collective_bytes`` (counted at the call; the reference
                parses compiled HLO, ``repro.dist.hlo_analysis``)

The reference's ``sharding`` (GSPMD partition specs) is not ported yet.
"""
from repro_torch.dist import collectives
from repro_torch.dist.collectives import (CollectiveStats, collective_bytes,
                                          logical_upload_bytes,
                                          policy_traffic_summary)

__all__ = ["collectives", "collective_bytes", "CollectiveStats",
           "logical_upload_bytes", "policy_traffic_summary"]
