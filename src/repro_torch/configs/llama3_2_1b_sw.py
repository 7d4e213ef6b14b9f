"""llama3.2-1b-sw — llama3.2-1b with a 4096-token sliding window, which
makes the dense family sub-quadratic (the values of
``repro.configs.llama3_2_1b_sw``)."""
from repro_torch.configs.llama3_2_1b import get_config as _base


def get_config(**kw):
    return _base(arch_id="llama3.2-1b-sw", window=4096, **kw)
