"""The legacy per-leaf LAG-trigger kernels on Hopper: the launches of
``csrc/lag_trigger.cu`` (port of the five Pallas kernels of
``repro.kernels.lag_trigger.lag_trigger``).

Each kernel takes one contiguous leaf of any shape and size: it masks the
ragged tail itself, so nothing is padded (the reference pads every leaf to
a multiple of 256 × 128).  Operands must lie on one CUDA device.  The
Pallas kernels cast every operand to float32 inside; the CUDA kernels load
each operand at its own dtype and widen it exactly, in the operand
combinations ``ENTRIES`` lists: a bfloat16 or float16 tree's leaves
((bf16, bf16), (f16, f16)), a float32 gradient against a bfloat16 or
float16 ĝ ((f32, bf16), (f32, f16)), LAQ's residual float32 beside any.
Any other combination raises ``TypeError`` on every device
(``check_dtypes``; ``ops`` checks CPU tensors too).  The sums come
back as 0-d float32 tensors on the device.  ``LAUNCHES`` counts the
launches of each instantiation (the kernel's name, with ``SUFFIX`` for a
2-byte operand); nothing else increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16
#: the operand-type instantiations of ``csrc/lag_trigger.cu``: (first,
#: second) operand dtypes → C entry suffix (a bfloat16 or float16 tree's
#: leaves; a float32 gradient against a bfloat16 or float16 ĝ)
_PAIRS = {(_F32, _F32): "", (_BF16, _BF16): "_bb", (_F32, _BF16): "_fb",
          (_F16, _F16): "_hh", (_F32, _F16): "_fh"}
#: the instantiations ``csrc/lag_trigger.cu`` builds, per kernel: operand
#: dtypes → C entry (delta_sqnorm and masked_update (a, b), the update
#: written at b's dtype; sqnorm (a,); absmax and encode (g, q, e), e and
#: the encode's payload and residual float32)
ENTRIES: Dict[str, Dict[Tuple[torch.dtype, ...], str]] = {
    "delta_sqnorm_2d": {d: "lag_sq_2d" + x for d, x in _PAIRS.items()},
    "sqnorm_2d": {(_F32,): "lag_sq_2d", (_BF16,): "lag_sq_2d_bb",
                  (_F16,): "lag_sq_2d_hh"},
    "masked_update_2d": {d: "lag_masked_update_2d" + x
                         for d, x in _PAIRS.items()},
    "innovation_absmax_2d": {d + (_F32,): "lag_absmax_2d" + x
                             for d, x in _PAIRS.items()},
    "laq_encode_2d": {d + (_F32,): "lag_laq_encode_2d" + x
                      for d, x in _PAIRS.items()},
}
#: an instantiation's name in ``LAUNCHES``: the kernel's, with a suffix for
#: a 2-byte operand (its C entry's; ``_bf16`` / ``_f16`` for one operand)
SUFFIX = {(_F32,): "", (_BF16,): "_bf16", (_F16,): "_f16", **_PAIRS,
          **{d + (_F32,): x for d, x in _PAIRS.items()}}

#: blocks of a reduction's first pass (8 of 256 threads on each of the
#: H100's 132 SMs); the second pass folds their partials
PARTIALS = 132 * 8

#: launches of each instantiation since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {k + SUFFIX[dts]: 0
                            for k, v in ENTRIES.items() for dts in v}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGS = {"lag_sq_2d": (_P, _P, _P, _P, _I64, _I, _I64),
         "lag_masked_update_2d": (_P, _P, _P, _P, _I64, _I),
         "lag_absmax_2d": (_P, _P, _P, _P, _P, _I64, _I, _I64),
         "lag_laq_encode_2d": (_P, _P, _P, _P, _P, _P, _P, _P, _I64,
                               ctypes.c_float, _I, _I64)}
#: ``--fmad=false``: ``v - codes*step`` must never become an FMA, so the LAQ
#: payload/residual equal the plain version bit for bit
LIBRARY = build.CudaLibrary(
    "lag_trigger", Path(__file__).resolve().parent / "csrc"
    / "lag_trigger.cu",
    {entry: _ARGS[entry.rsplit("_2d", 1)[0] + "_2d"]
     for v in ENTRIES.values() for entry in v.values()},
    extra_flags=("--fmad=false",))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_dtypes(name: str, *xs: torch.Tensor) -> Tuple[torch.dtype, ...]:
    """The operands' dtypes, when ``name`` has an instantiation for them;
    ``TypeError`` otherwise (there is no widening fallback)."""
    dts = tuple(x.dtype for x in xs)
    if dts not in ENTRIES[name]:
        raise TypeError(f"{name}: no instantiation for operand dtypes "
                        f"{tuple(str(d) for d in dts)}; built: "
                        f"{[tuple(str(d) for d in k) for k in ENTRIES[name]]}")
    return dts


def _check(name: str, *xs: torch.Tensor) -> Tuple[str, int]:
    """Raise on operands the kernel does not take; return the C entry of
    their dtypes and 1 when every operand is aligned for the kernel's
    4-element vector loads (0: the scalar path)."""
    dts = check_dtypes(name, *xs)
    dev = xs[0].device
    if not all(x.is_cuda and x.device == dev for x in xs):
        raise ValueError(f"{name}: CUDA operands on one device required, "
                         f"got {[str(x.device) for x in xs]}")
    if any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{name}: operand shapes differ: "
                         f"{[tuple(x.shape) for x in xs]}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name}: operands must be contiguous")
    vec = int(all(x.data_ptr() % (4 * x.element_size()) == 0 for x in xs))
    return ENTRIES[name][dts], vec


def _launch(name: str, entry: str, xs, *args, device) -> None:
    build.launch(getattr(build.load(LIBRARY), entry), *args, device=device)
    LAUNCHES[name + SUFFIX[tuple(x.dtype for x in xs)]] += 1


def _scalar_operand(name: str, s: torch.Tensor, like: torch.Tensor
                    ) -> torch.Tensor:
    if s.numel() != 1 or s.device != like.device:
        raise ValueError(f"{name}: want one value on {like.device}, got "
                         f"shape {tuple(s.shape)} on {s.device}")
    return s.reshape(()).to(torch.float32).contiguous()


def _sq(name: str, a: torch.Tensor, b) -> torch.Tensor:
    xs = (a,) if b is None else (a, b)
    entry, vec = _check(name, *xs)
    part = torch.empty((PARTIALS,), dtype=torch.float32, device=a.device)
    out = torch.empty((), dtype=torch.float32, device=a.device)
    _launch(name, entry, xs, a.data_ptr(),
            None if b is None else b.data_ptr(), part.data_ptr(),
            out.data_ptr(), a.numel(), vec, PARTIALS, device=a.device)
    return out


def delta_sqnorm_2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖a − b‖² in float32 → 0-d tensor on the device."""
    return _sq("delta_sqnorm_2d", a, b)


def sqnorm_2d(a: torch.Tensor) -> torch.Tensor:
    """‖a‖² in float32 → 0-d tensor on the device."""
    return _sq("sqnorm_2d", a, None)


def masked_update_2d(a: torch.Tensor, b: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """b + mask·(a − b) elementwise, computed in float32 and rounded once
    to ``b``'s dtype; ``mask`` is one value (bool or float) on the
    operands' device."""
    entry, vec = _check("masked_update_2d", a, b)
    m = _scalar_operand("masked_update_2d: mask", mask, b)
    out = torch.empty_like(b)
    if b.numel():
        _launch("masked_update_2d", entry, (a, b), a.data_ptr(),
                b.data_ptr(), m.data_ptr(), out.data_ptr(), b.numel(), vec,
                device=b.device)
    return out


def innovation_absmax_2d(g: torch.Tensor, q: torch.Tensor,
                         e: torch.Tensor) -> torch.Tensor:
    """max|(g − q) + e| in float32 → 0-d tensor on the device (0 for an
    empty leaf: the Pallas kernel starts from 0)."""
    entry, vec = _check("innovation_absmax_2d", g, q, e)
    part = torch.empty((PARTIALS,), dtype=torch.float32, device=g.device)
    out = torch.empty((), dtype=torch.float32, device=g.device)
    _launch("innovation_absmax_2d", entry, (g, q, e), g.data_ptr(),
            q.data_ptr(), e.data_ptr(), part.data_ptr(), out.data_ptr(),
            g.numel(), vec, PARTIALS, device=g.device)
    return out


def laq_encode_2d(g: torch.Tensor, q: torch.Tensor, e: torch.Tensor,
                  scale: torch.Tensor, bits: int):
    """Fused b-bit quantize + error-feedback residual + ‖payload‖² in one
    sweep → (payload, residual, 0-d Σ payload²), float32 whatever g's and
    q's dtypes.  ``scale`` is the 0-d device absmax; the kernel divides
    the step scale/(2^{b−1}−1) itself."""
    if not 2 <= bits <= 16:
        raise ValueError(f"laq_encode_2d: bits must be in [2, 16], got "
                         f"{bits}")
    entry, vec = _check("laq_encode_2d", g, q, e)
    s = _scalar_operand("laq_encode_2d: scale", scale, g)
    # the allocator's blocks are 512-byte aligned: p and r never break vec
    p, r = torch.empty_like(e), torch.empty_like(e)
    part = torch.empty((PARTIALS,), dtype=torch.float32, device=g.device)
    sq = torch.empty((), dtype=torch.float32, device=g.device)
    _launch("laq_encode_2d", entry, (g, q, e), g.data_ptr(), q.data_ptr(),
            e.data_ptr(), s.data_ptr(), p.data_ptr(), r.data_ptr(),
            part.data_ptr(), sq.data_ptr(), g.numel(),
            float(2 ** (bits - 1) - 1), vec, PARTIALS, device=g.device)
    return p, r, sq
