"""Rotary position embeddings (half-split, llama convention): standard RoPE
and Qwen2-VL's M-RoPE — port of ``repro.models.rope``.

M-RoPE (arXiv:2409.12191): the head_dim/2 frequency pairs are split into
three contiguous sections (temporal, height, width); each section takes its
rotation angle from the matching component of a 3-D position id.  For
pure-text positions all three components are equal and M-RoPE is RoPE.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

#: Qwen2-VL's split of the 64 frequency pairs (head_dim 128)
MROPE_SECTIONS = (16, 24, 24)


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


def mrope_angles(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: Sequence[int] = MROPE_SECTIONS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions3 (3, ..., S) → cos, sin (..., S, head_dim//2).

    ``sections`` are in frequency pairs and sum to head_dim//2; for another
    head_dim (the reduced configs) they are rescaled in proportion, the
    last one taking the remainder, as the reference does."""
    half = head_dim // 2
    if sum(sections) != half:
        total = sum(sections)
        scaled = [s * half // total for s in sections]
        scaled[-1] += half - sum(scaled)
        sections = scaled
    cos, sin = rope_angles(positions3, head_dim, theta)   # (3, ..., S, half)
    starts = [sum(sections[:i]) for i in range(len(sections))]
    return (torch.cat([cos[i, ..., a:a + n] for i, (a, n)
                       in enumerate(zip(starts, sections))], -1),
            torch.cat([sin[i, ..., a:a + n] for i, (a, n)
                       in enumerate(zip(starts, sections))], -1))


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """x (B, S, H, head_dim); cos/sin (B, S, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
