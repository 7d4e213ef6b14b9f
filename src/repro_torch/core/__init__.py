"""LAG core: trigger rules, JAX-ordered pytrees, the convex problems and
their simulation driver (port of ``repro.core``)."""
from repro_torch.core.lag import (LAGConfig, hist_init, hist_push,
                                  ps_communicate, rhs_underflow, trigger_rhs,
                                  tree_sqnorm, wk_communicate)
from repro_torch.core.convex import (Problem, gisette_standin, real_standin,
                                     synthetic)
from repro_torch.core.simulate import ALGOS, run
