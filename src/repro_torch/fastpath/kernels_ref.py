"""Plain PyTorch versions of the comm plane's five kernels.

Same function and same per-(worker, sub-block) partials as the CUDA
kernels in ``csrc/fastpath_kernels.cu`` (and the Pallas kernels of
``repro.fastpath.kernels`` they replace), written with ordinary tensor ops.
``repro_torch.fastpath.kernels`` runs these for tensors on the CPU; the
tests and ``chip_smoke.py`` hold the kernels against them.  Every op is
local to a sub-block, so a caller may apply them to any run of whole
sub-blocks (rows a multiple of ``SUB_ROWS``) and concatenate.

Operands may be float32, bfloat16 or float16 (``kernels.ENTRIES``): each
is widened to float32 first (exact), every op is float32 as in the kernels,
and ``masked_combine`` rounds its result once to ``b``'s dtype.
"""
from __future__ import annotations

import torch

from repro_torch.fastpath.layout import LANES, SUB_ROWS

MASK_MODES = ("add", "update", "select")


def _subs(x: torch.Tensor) -> torch.Tensor:
    """(W, R, LANES) → (W, R/SUB_ROWS, SUB_ROWS·LANES) sub-block-major."""
    return x.reshape(x.shape[0], x.shape[1] // SUB_ROWS, SUB_ROWS * LANES)


def delta_sqnorm_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sub-block Σ(a − b)²: (W, R, L) × (W|·, R, L) → (W, R/8)."""
    d = a.float() - b.float()
    if d.dim() == 2:
        d = d[None]
    return torch.sum(_subs(d * d), dim=-1)


def sqnorm_blocks(a: torch.Tensor) -> torch.Tensor:
    """Per-sub-block Σa²: (W, R, L) → (W, R/8)."""
    x = a.float()
    return torch.sum(_subs(x * x), dim=-1)


def absmax_blocks(g: torch.Tensor, q: torch.Tensor,
                  e: torch.Tensor) -> torch.Tensor:
    """Per-sub-block max|(g − q) + e| — the LAQ quantizer-scale sweep."""
    v = (g.float() - q.float()) + e.float()
    return torch.amax(torch.abs(_subs(v)), dim=-1)


def laq_encode_blocks(g: torch.Tensor, q: torch.Tensor, e: torch.Tensor,
                      steps_subs: torch.Tensor, bits: int):
    """Fused b-bit encode: (payload, residual, Σ payload² per sub-block).

    ``steps_subs`` (W, R/8) is the already-divided quantizer step of each
    sub-block's leaf; ``inv`` is a zero-guarded division and rounding is
    half-to-even (``torch.round``), as the reference kernel.
    """
    qmax = float(2 ** (bits - 1) - 1)
    v = _subs((g.float() - q.float()) + e.float())
    step = steps_subs.float()[..., None]
    pos = step > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, step, torch.ones_like(step)),
                      torch.zeros_like(step))
    codes = torch.clamp(torch.round(v * inv), -qmax, qmax)
    p = codes * step
    resid = v - p
    sq = torch.sum(p * p, dim=-1)
    return p.reshape(g.shape), resid.reshape(g.shape), sq


def masked_combine(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """Per-worker masked fold of candidate ``a`` (W, R, L) or (R, L) into
    state ``b`` (W, R, L), in float32, at ``b``'s dtype: add b + m·a,
    update b + m·(a − b), select where(m, a, b) — an exact copy."""
    if mode not in MASK_MODES:
        raise ValueError(f"mode must be one of {MASK_MODES}, got {mode!r}")
    m = mask.to(torch.float32).reshape(-1, 1, 1)
    x, y = a.float(), b.float()
    if mode == "add":
        out = y + m * x
    elif mode == "update":
        out = y + m * (x - y)
    else:
        out = torch.where(m != 0.0, x, y)
    return out.to(b.dtype)
