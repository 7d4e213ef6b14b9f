"""repro_torch.devrun — the device plane: one lazy worker per rank of a
``torch.distributed`` group — port of ``repro.devrun``.

Topology spec ``devices:D``: the policies' packed wire tensors gathered
between ranks instead of dense float32 deltas, and the counted collective
bytes held against the wire format's prediction.  ``runner`` has the
state and step builders, the round loop, the checkpoints and ``launch``
(spawn D ranks); ``verify`` the wire accounting, which reads the records
the plane's collective wrapper writes (``repro_torch.dist.collectives``)
where the reference reads its compiled HLO.
"""
from repro_torch.devrun.runner import (BACKENDS, check_backend,
                                       init_device_state, launch,
                                       make_device_step, rank_device,
                                       restore_checkpoint, run_rounds,
                                       save_checkpoint)
from repro_torch.devrun.verify import (FRAMING_TOLERANCE, GATHER_REL_TOL,
                                       assert_wire_accounting,
                                       check_wire_accounting, framing_ratio,
                                       predicted_collective_bytes)

__all__ = [
    "init_device_state", "make_device_step", "run_rounds",
    "predicted_collective_bytes", "framing_ratio", "check_wire_accounting",
    "assert_wire_accounting", "FRAMING_TOLERANCE", "GATHER_REL_TOL",
    "launch", "check_backend", "rank_device", "save_checkpoint",
    "restore_checkpoint", "BACKENDS",
]
