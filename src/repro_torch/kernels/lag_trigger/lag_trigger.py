"""The legacy per-leaf LAG-trigger kernels on Hopper: the launches of
``csrc/lag_trigger.cu`` (port of the five Pallas kernels of
``repro.kernels.lag_trigger.lag_trigger``).

Each kernel takes one contiguous leaf of any shape and size: it masks the
ragged tail itself, so nothing is padded (the reference pads every leaf to
a multiple of 256 × 128).  Operands must lie on one CUDA device; the three
kernels whose reference tests cover bfloat16 (the two sums and the masked
update) take float32 or bfloat16, absmax and encode take float32.  The sums
come back as 0-d float32 tensors on the device.  ``LAUNCHES`` counts the
launches per kernel; nothing else increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import build

#: blocks of a reduction's first pass (8 of 256 threads on each of the
#: H100's 132 SMs); the second pass folds their partials
PARTIALS = 132 * 8

#: kernel launches since the last ``reset_launches()``, per kernel
LAUNCHES: Dict[str, int] = {"delta_sqnorm_2d": 0, "sqnorm_2d": 0,
                            "masked_update_2d": 0,
                            "innovation_absmax_2d": 0, "laq_encode_2d": 0}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: ``--fmad=false``: ``v - codes*step`` must never become an FMA, so the LAQ
#: payload/residual equal the plain version bit for bit
LIBRARY = build.CudaLibrary(
    "lag_trigger", Path(__file__).resolve().parent / "csrc"
    / "lag_trigger.cu",
    {"lag_sq_2d": (_P, _P, _P, _P, _I64, _I, _I, _I64),
     "lag_masked_update_2d": (_P, _P, _P, _P, _I64, _I, _I),
     "lag_absmax_2d": (_P, _P, _P, _P, _P, _I64, _I, _I64),
     "lag_laq_encode_2d": (_P, _P, _P, _P, _P, _P, _P, _P, _I64,
                           ctypes.c_float, _I, _I64)},
    extra_flags=("--fmad=false",))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, dtypes, *xs: torch.Tensor) -> int:
    """Raise on operands the kernel does not take; return 1 when every
    operand is aligned for the kernel's 4-element vector loads (and 0 for
    the scalar path)."""
    dev = xs[0].device
    if not all(x.is_cuda and x.device == dev for x in xs):
        raise ValueError(f"{name}: CUDA operands on one device required, "
                         f"got {[str(x.device) for x in xs]}")
    if any(x.dtype != xs[0].dtype for x in xs) or xs[0].dtype not in dtypes:
        raise TypeError(f"{name}: operands of one dtype in "
                        f"{[str(d) for d in dtypes]} required, got "
                        f"{[str(x.dtype) for x in xs]}")
    if any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{name}: operand shapes differ: "
                         f"{[tuple(x.shape) for x in xs]}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name}: operands must be contiguous")
    width = 4 * xs[0].element_size()
    return int(all(x.data_ptr() % width == 0 for x in xs))


def _scalar_operand(name: str, s: torch.Tensor, like: torch.Tensor
                    ) -> torch.Tensor:
    if s.numel() != 1 or s.device != like.device:
        raise ValueError(f"{name}: want one value on {like.device}, got "
                         f"shape {tuple(s.shape)} on {s.device}")
    return s.reshape(()).to(torch.float32).contiguous()


def _sq(name: str, a: torch.Tensor, b) -> torch.Tensor:
    ops = (a,) if b is None else (a, b)
    vec = _check(name, tuple(_DTYPE_CODES), *ops)
    part = torch.empty((PARTIALS,), dtype=torch.float32, device=a.device)
    out = torch.empty((), dtype=torch.float32, device=a.device)
    build.launch(build.load(LIBRARY).lag_sq_2d, a.data_ptr(),
                 None if b is None else b.data_ptr(), part.data_ptr(),
                 out.data_ptr(), a.numel(), _DTYPE_CODES[a.dtype], vec,
                 PARTIALS, device=a.device)
    LAUNCHES[name] += 1
    return out


def delta_sqnorm_2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖a − b‖² in float32 → 0-d tensor on the device."""
    return _sq("delta_sqnorm_2d", a, b)


def sqnorm_2d(a: torch.Tensor) -> torch.Tensor:
    """‖a‖² in float32 → 0-d tensor on the device."""
    return _sq("sqnorm_2d", a, None)


def masked_update_2d(a: torch.Tensor, b: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """b + mask·(a − b) elementwise, in ``b``'s dtype; ``mask`` is one
    value (bool or float) on the operands' device."""
    vec = _check("masked_update_2d", tuple(_DTYPE_CODES), a, b)
    m = _scalar_operand("masked_update_2d: mask", mask, b)
    out = torch.empty_like(b)
    if b.numel():
        build.launch(build.load(LIBRARY).lag_masked_update_2d, a.data_ptr(),
                     b.data_ptr(), m.data_ptr(), out.data_ptr(), b.numel(),
                     _DTYPE_CODES[b.dtype], vec, device=b.device)
        LAUNCHES["masked_update_2d"] += 1
    return out


def innovation_absmax_2d(g: torch.Tensor, q: torch.Tensor,
                         e: torch.Tensor) -> torch.Tensor:
    """max|(g − q) + e| in float32 → 0-d tensor on the device (0 for an
    empty leaf: the Pallas kernel starts from 0)."""
    vec = _check("innovation_absmax_2d", (torch.float32,), g, q, e)
    part = torch.empty((PARTIALS,), dtype=torch.float32, device=g.device)
    out = torch.empty((), dtype=torch.float32, device=g.device)
    build.launch(build.load(LIBRARY).lag_absmax_2d, g.data_ptr(),
                 q.data_ptr(), e.data_ptr(), part.data_ptr(), out.data_ptr(),
                 g.numel(), vec, PARTIALS, device=g.device)
    LAUNCHES["innovation_absmax_2d"] += 1
    return out


def laq_encode_2d(g: torch.Tensor, q: torch.Tensor, e: torch.Tensor,
                  scale: torch.Tensor, bits: int):
    """Fused b-bit quantize + error-feedback residual + ‖payload‖² in one
    sweep → (payload, residual, 0-d Σ payload²), float32.  ``scale`` is
    the 0-d device absmax; the kernel divides the step scale/(2^{b−1}−1)
    itself."""
    if not 2 <= bits <= 16:
        raise ValueError(f"laq_encode_2d: bits must be in [2, 16], got "
                         f"{bits}")
    vec = _check("laq_encode_2d", (torch.float32,), g, q, e)
    s = _scalar_operand("laq_encode_2d: scale", scale, g)
    # the allocator's blocks are 512-byte aligned: p and r never break vec
    p, r = torch.empty_like(g), torch.empty_like(g)
    part = torch.empty((PARTIALS,), dtype=torch.float32, device=g.device)
    sq = torch.empty((), dtype=torch.float32, device=g.device)
    build.launch(build.load(LIBRARY).lag_laq_encode_2d, g.data_ptr(),
                 q.data_ptr(), e.data_ptr(), s.data_ptr(), p.data_ptr(),
                 r.data_ptr(), part.data_ptr(), sq.data_ptr(), g.numel(),
                 float(2 ** (bits - 1) - 1), vec, PARTIALS, device=g.device)
    LAUNCHES["laq_encode_2d"] += 1
    return p, r, sq
