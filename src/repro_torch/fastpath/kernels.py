"""The comm plane's five kernels: dispatch to CUDA (Hopper) or the plain
version — port of ``repro.fastpath.kernels``.

Each wrapper takes the layout's float32 flat buffers.  For tensors on the
CPU it runs the plain PyTorch version (``kernels_ref``); for CUDA tensors
it launches the hand-written kernel of ``csrc/fastpath_kernels.cu`` or
raises — there is no fallback.  The kernels are compiled with ``nvcc`` for
``sm_90a`` at first use by the port's shared builder
(``repro_torch.kernels.build``) and bound through a plain C interface with
``ctypes``.  ``LAUNCHES`` counts the kernel launches per kernel; nothing
else increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.fastpath import kernels_ref
from repro_torch.fastpath.layout import LANES, SUB_ROWS
from repro_torch.kernels import build

MASK_MODES = kernels_ref.MASK_MODES

#: kernel launches since the last ``reset_launches()``, per kernel
LAUNCHES: Dict[str, int] = {"delta_sqnorm_blocks": 0, "sqnorm_blocks": 0,
                            "absmax_blocks": 0, "laq_encode_blocks": 0,
                            "masked_combine": 0}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
#: ``--fmad=false``: ``v - codes*step`` must never become an FMA, so the LAQ
#: payload/residual equal the plain version bit for bit
LIBRARY = build.CudaLibrary(
    "fastpath", Path(__file__).resolve().parent / "csrc"
    / "fastpath_kernels.cu",
    {"lag_delta_sq_blocks": (_P, _P, _P, _I64, _I64, _I64, _I64),
     "lag_sq_blocks": (_P, _P, _I64),
     "lag_absmax_blocks": (_P, _P, _P, _P, _I64),
     "lag_laq_encode_blocks": (_P, _P, _P, _P, _P, _P, _P, _I64,
                               ctypes.c_float),
     "lag_masked_combine": (_P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int)},
    extra_flags=("--fmad=false",))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------

def _check(name: str, x: torch.Tensor, ndims=(3,)) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {x.dtype}")
    if x.dim() not in ndims or x.shape[-1] != LANES \
            or x.shape[-2] % SUB_ROWS:
        raise ValueError(f"{name}: want (W, R, {LANES}) with R % {SUB_ROWS}"
                         f" == 0, got {tuple(x.shape)}")
    if x.is_cuda and (not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{name}: CUDA operand must be contiguous and "
                         f"16-byte aligned")


def _same_device(*xs: torch.Tensor) -> bool:
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"operands on different devices: "
                         f"{[str(x.device) for x in xs]}")
    return xs[0].is_cuda


# ---------------------------------------------------------------------------
# The five kernels
# ---------------------------------------------------------------------------

def delta_sqnorm_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sub-block partials of ‖a − b‖²: (W, R, L) × (W|·, R, L) →
    (W, R/8).  ``b`` may be the unstacked (R, L) shared tree."""
    _check("a", a)
    _check("b", b, (2, 3))
    if b.shape[-2:] != a.shape[-2:] or (b.dim() == 3
                                         and b.shape[0] != a.shape[0]):
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if not _same_device(a, b):
        return kernels_ref.delta_sqnorm_blocks(a, b)
    W, R = a.shape[0], a.shape[1]
    out = torch.empty((W, R // SUB_ROWS), dtype=torch.float32,
                      device=a.device)
    vec = R * LANES // 4
    build.launch(build.load(LIBRARY).lag_delta_sq_blocks, a.data_ptr(),
                 b.data_ptr(), out.data_ptr(), W, R // SUB_ROWS, vec,
                 vec if b.dim() == 3 else 0, device=a.device)
    LAUNCHES["delta_sqnorm_blocks"] += 1
    return out


def sqnorm_blocks(a: torch.Tensor) -> torch.Tensor:
    """Per-sub-block partials of ‖a‖²: (W, R, L) → (W, R/8)."""
    _check("a", a)
    if not a.is_cuda:
        return kernels_ref.sqnorm_blocks(a)
    W, R = a.shape[0], a.shape[1]
    out = torch.empty((W, R // SUB_ROWS), dtype=torch.float32,
                      device=a.device)
    build.launch(build.load(LIBRARY).lag_sq_blocks, a.data_ptr(),
                 out.data_ptr(), W * (R // SUB_ROWS), device=a.device)
    LAUNCHES["sqnorm_blocks"] += 1
    return out


def absmax_blocks(g: torch.Tensor, q: torch.Tensor,
                  e: torch.Tensor) -> torch.Tensor:
    """Per-sub-block max|(g − q) + e| — the LAQ quantizer-scale sweep."""
    for n, x in (("g", g), ("q", q), ("e", e)):
        _check(n, x)
    if not (g.shape == q.shape == e.shape):
        raise ValueError("absmax_blocks: operand shapes differ")
    if not _same_device(g, q, e):
        return kernels_ref.absmax_blocks(g, q, e)
    W, R = g.shape[0], g.shape[1]
    out = torch.empty((W, R // SUB_ROWS), dtype=torch.float32,
                      device=g.device)
    build.launch(build.load(LIBRARY).lag_absmax_blocks, g.data_ptr(),
                 q.data_ptr(), e.data_ptr(), out.data_ptr(),
                 W * (R // SUB_ROWS), device=g.device)
    LAUNCHES["absmax_blocks"] += 1
    return out


def laq_encode_blocks(g: torch.Tensor, q: torch.Tensor, e: torch.Tensor,
                      steps_subs: torch.Tensor, bits: int,
                      payload_out: Optional[torch.Tensor] = None):
    """Fused b-bit encode over the batched flat buffer → (payload (W, R, L),
    residual (W, R, L), Σ payload² per sub-block (W, R/8)).

    ``steps_subs`` is the (W, R/8) per-sub-block quantizer step, already
    divided by qmax.  ``payload_out`` (may be ``g`` itself) receives the
    payload instead of a new buffer.
    """
    for n, x in (("g", g), ("q", q), ("e", e)):
        _check(n, x)
    if not (g.shape == q.shape == e.shape):
        raise ValueError("laq_encode_blocks: operand shapes differ")
    W, R = g.shape[0], g.shape[1]
    if steps_subs.shape != (W, R // SUB_ROWS) \
            or steps_subs.dtype != torch.float32:
        raise ValueError(f"steps_subs: want float32 {(W, R // SUB_ROWS)}, "
                         f"got {steps_subs.dtype} {tuple(steps_subs.shape)}")
    if payload_out is not None:
        _check("payload_out", payload_out)
        if payload_out.shape != g.shape:
            raise ValueError("payload_out: shape differs from g")
    if not _same_device(g, q, e, steps_subs):
        p, r, sq = kernels_ref.laq_encode_blocks(g, q, e, steps_subs, bits)
        if payload_out is not None:
            p = payload_out.copy_(p)
        return p, r, sq
    steps_subs = steps_subs.contiguous()
    p = torch.empty_like(g) if payload_out is None else payload_out
    r = torch.empty_like(g)
    sq = torch.empty((W, R // SUB_ROWS), dtype=torch.float32,
                     device=g.device)
    build.launch(build.load(LIBRARY).lag_laq_encode_blocks, g.data_ptr(),
                 q.data_ptr(), e.data_ptr(), steps_subs.data_ptr(),
                 p.data_ptr(), r.data_ptr(), sq.data_ptr(),
                 W * (R // SUB_ROWS), float(2 ** (bits - 1) - 1),
                 device=g.device)
    LAUNCHES["laq_encode_blocks"] += 1
    return p, r, sq


def masked_combine(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                   mode: str, out: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Per-worker masked fold of candidate ``a`` into state ``b``.

    ``mask`` is (W,) bool/float; ``mode`` ∈ ``MASK_MODES``.  ``select``
    copies bit-exactly.  ``a`` may be unstacked (R, L).  ``out`` (may be
    ``b`` itself, for an in-place state update) receives the result.
    """
    if mode not in MASK_MODES:
        raise ValueError(f"mode must be one of {MASK_MODES}, got {mode!r}")
    _check("a", a, (2, 3))
    _check("b", b)
    W, R = b.shape[0], b.shape[1]
    if a.shape[-2:] != b.shape[-2:] or (a.dim() == 3 and a.shape[0] != W):
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if mask.shape != (W,):
        raise ValueError(f"mask: want shape ({W},), got {tuple(mask.shape)}")
    if out is not None:
        _check("out", out)
        if out.shape != b.shape:
            raise ValueError("out: shape differs from b")
    if not _same_device(a, b, mask):
        res = kernels_ref.masked_combine(a, b, mask, mode)
        return res if out is None else out.copy_(res)
    m = mask.to(torch.float32).contiguous()
    res = torch.empty_like(b) if out is None else out
    vec = R * LANES // 4
    build.launch(build.load(LIBRARY).lag_masked_combine, a.data_ptr(),
                 b.data_ptr(), m.data_ptr(), res.data_ptr(), W, vec,
                 vec if a.dim() == 3 else 0, MASK_MODES.index(mode),
                 device=b.device)
    LAUNCHES["masked_combine"] += 1
    return res
