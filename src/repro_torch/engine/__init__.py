"""``repro_torch.engine`` — the shared LAG round, the server optimizers,
the topologies and the front door (port of ``repro.engine``).

    from repro_torch.engine import Experiment
    r = Experiment(problem=prob, algo="lag-wk", steps=3000).run()
    r.comms_to(1e-8), r.bytes_to(1e-8)
    Experiment(model="llama3.2-1b", topology="pods:2", steps=10).run()
"""
from repro_torch.engine.server import (AdamServer, MomentumServer,
                                       ProxL1Server, SERVERS, SGDServer,
                                       ServerOptimizer, make_server)
from repro_torch.engine.rounds import lag_round, policy_rounds, sum_reduce
from repro_torch.engine.report import RunReport
from repro_torch.engine.topology import (AsyncShards, BatchShards,
                                         DeviceWorkers, PodMesh, SimWorkers,
                                         TOPOLOGIES, Topology, make_topology,
                                         split_batch)
from repro_torch.engine.experiment import Experiment

# re-exported for one-stop spec building (the policy axis lives in
# repro_torch.comm; schedules are policies)
from repro_torch.comm import (POLICIES, CyclicSchedule, SampledSchedule,
                              ScheduledPolicy, make_policy)

#: ``engine.round`` — the shared round
round = lag_round

__all__ = [
    "Experiment", "RunReport", "round", "lag_round", "policy_rounds",
    "sum_reduce", "ServerOptimizer", "SGDServer", "MomentumServer",
    "AdamServer", "ProxL1Server", "SERVERS", "make_server", "SimWorkers",
    "BatchShards", "PodMesh", "AsyncShards", "DeviceWorkers", "Topology",
    "TOPOLOGIES",
    "make_topology", "split_batch", "POLICIES",
    "make_policy", "ScheduledPolicy", "CyclicSchedule", "SampledSchedule",
]
