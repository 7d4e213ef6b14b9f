"""Architecture registry of the port: ``get_config(arch_id, **overrides)``.
Only the dense llama family is ported."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.common import ModelConfig

_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
}


def get_config(arch_id: str, **overrides) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port has: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).get_config(**overrides)
