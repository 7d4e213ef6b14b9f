"""The batched flat-buffer comm plane (port of ``repro.fastpath``)."""
from repro_torch.fastpath.layout import (BLOCK_ROWS, LANES, SUB, SUB_ROWS,
                                         FlatLayout)
from repro_torch.fastpath.plan import (MODES, FastPathPlan, active_plan,
                                       make_plan)

__all__ = ["BLOCK_ROWS", "LANES", "SUB", "SUB_ROWS", "FlatLayout", "MODES",
           "FastPathPlan", "active_plan", "make_plan"]
