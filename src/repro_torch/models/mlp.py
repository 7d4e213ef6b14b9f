"""Dense SwiGLU feed-forward (the llama family) — port of
``repro.models.mlp``."""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import ModelConfig


def shapes(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_up": (d, ff), "w_down": (ff, d), "w_gate": (d, ff)}


def apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    up = x @ p["w_up"].to(dt)
    h = common.swiglu(x @ p["w_gate"].to(dt), up)
    return h @ p["w_down"].to(dt)
