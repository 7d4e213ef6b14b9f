"""Rotary position embeddings (half-split, llama convention) — port of
``repro.models.rope`` (standard RoPE; M-RoPE is not ported yet)."""
from __future__ import annotations

from typing import Tuple

import torch


def _inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int → cos, sin (..., S, head_dim//2) float32."""
    ang = positions[..., None].to(torch.float32) \
        * _inv_freq(head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """x (B, S, H, head_dim); cos/sin (B, S, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
