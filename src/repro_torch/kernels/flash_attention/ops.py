"""Attention with any S — port of ``repro.kernels.flash_attention.ops``.

CPU tensors take the plain version (``ref.attention``); CUDA tensors the
hand-written kernel (``flash_attention.flash_attention_fwd``), which masks
ragged lengths itself instead of padding them to a block multiple.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,Skv,KV,hd) → (B,S,H,hd)."""
    if not on_cuda(q):
        return ref.attention(q, k, v, causal=causal, window=window)
    return flash_attention_fwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window)
