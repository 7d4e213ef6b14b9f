"""Architecture registry of the port: ``get_config(arch_id, **overrides)``.
The port has all eleven of the reference's architectures, of the
``dense``, ``lattn``, ``rec``, ``ssd`` and ``moe`` layer kinds."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.common import ModelConfig

_MODULES: Dict[str, str] = {
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "llama3.2-1b-sw": "repro_torch.configs.llama3_2_1b_sw",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
}

#: the assignment's architectures (all but the sliding-window variant)
ASSIGNED = [a for a in _MODULES if a != "llama3.2-1b-sw"]
#: every architecture the port has
ALL_ARCHS = list(_MODULES)


def get_config(arch_id: str, **overrides) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port has: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).get_config(**overrides)
