"""Dense feed-forward: SwiGLU (the llama family), GeGLU (recurrentgemma)
or the two-matrix GELU (hubert), with ``b_up`` / ``b_down`` under
``use_bias`` — port of ``repro.models.mlp``."""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import ModelConfig


def gated(cfg: ModelConfig) -> bool:
    return cfg.act in ("swiglu", "geglu")


def shapes(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    out = {"w_up": (d, ff), "w_down": (ff, d)}
    if gated(cfg):
        out["w_gate"] = (d, ff)
    if cfg.use_bias:
        out.update(b_up=(ff,), b_down=(d,))
    return out


def init_(p: dict, cfg: ModelConfig, gen: torch.Generator) -> None:
    """Fan-in truncated-normal matrices and zero biases, in place (the
    leaves may carry a leading stack axis)."""
    common.projections_init_(p, {"w_up": cfg.d_model, "w_gate": cfg.d_model,
                                 "w_down": cfg.d_ff}, gen)


def apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    up = x @ p["w_up"].to(dt)
    if cfg.use_bias:
        up = up + p["b_up"].to(dt)
    if gated(cfg):
        h = common.activate(x @ p["w_gate"].to(dt), up, cfg.act)
    else:
        h = common.activate(up, None, "gelu")
    y = h @ p["w_down"].to(dt)
    if cfg.use_bias:
        y = y + p["b_down"].to(dt)
    return y
