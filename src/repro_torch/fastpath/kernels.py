"""The comm plane's five kernels: dispatch to CUDA (Hopper) or the plain
version — port of ``repro.fastpath.kernels``.

Each wrapper takes the layout's flat buffers, float32, bfloat16 or
float16 as ``ENTRIES`` lists per kernel: the operand combinations the comm
paths use (a bfloat16 or float16 model's buffers; a float32 model's
gradients against bfloat16 or float16 ĝ mirrors; LAQ's float32
residual).  Any other combination raises, on every device.  For tensors
on the CPU a wrapper runs the plain PyTorch
version (``kernels_ref``); for CUDA tensors it launches the hand-written
kernel of ``csrc/fastpath_kernels.cu`` or raises — there is no fallback;
for meta tensors it allocates the kernel's outputs and launches nothing
(``launch.dryrun`` reckons the card's memory so).  The kernels are
compiled with ``nvcc`` for ``sm_90a`` at first use by the port's shared
builder (``repro_torch.kernels.build``) and bound through a plain C
interface with ``ctypes``.  ``LAUNCHES`` counts the launches of each
instantiation (``masked_combine``, ``masked_combine_bb``,
``masked_combine_fh``, ``sqnorm_blocks_f16``, …); nothing else increments
it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.fastpath import kernels_ref
from repro_torch.fastpath.layout import LANES, SUB_ROWS
from repro_torch.kernels import build

MASK_MODES = kernels_ref.MASK_MODES

_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16
#: the two-operand instantiations: operand dtypes → C entry suffix (a
#: bfloat16 or float16 model's buffers; a float32 model's gradients
#: against bfloat16 or float16 ĝ mirrors)
_PAIRS = {(_F32, _F32): "", (_BF16, _BF16): "_bb", (_F32, _BF16): "_fb",
          (_F16, _F16): "_hh", (_F32, _F16): "_fh"}
#: the instantiations ``csrc/fastpath_kernels.cu`` builds, per kernel:
#: operand dtypes → C entry (delta_sqnorm (a, b); absmax and laq_encode
#: (g, q), their residual float32; masked_combine (a, b), written at b's;
#: sqnorm (a,))
ENTRIES: Dict[str, Dict[Tuple[torch.dtype, ...], str]] = {
    **{k: {dts: entry + sfx for dts, sfx in _PAIRS.items()}
       for k, entry in (("delta_sqnorm_blocks", "lag_delta_sq_blocks"),
                        ("absmax_blocks", "lag_absmax_blocks"),
                        ("laq_encode_blocks", "lag_laq_encode_blocks"),
                        ("masked_combine", "lag_masked_combine"))},
    "sqnorm_blocks": {(_F32,): "lag_sq_blocks",
                      (_BF16,): "lag_sq_blocks_bf16",
                      (_F16,): "lag_sq_blocks_f16"},
}
#: an instantiation's name in ``LAUNCHES``: its wrapper's name, with its C
#: entry's suffix for a 2-byte operand
SUFFIX = {(_F32,): "", (_BF16,): "_bf16", (_F16,): "_f16", **_PAIRS}

#: launches of each instantiation since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {k + SUFFIX[dts]: 0
                            for k, v in ENTRIES.items() for dts in v}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGS = {"delta_sqnorm_blocks": (_P, _P, _P, _I64, _I64, _I64, _I64),
         "sqnorm_blocks": (_P, _P, _I64),
         "absmax_blocks": (_P, _P, _P, _P, _I64),
         "laq_encode_blocks": (_P, _P, _P, _P, _P, _P, _P, _I64,
                               ctypes.c_float),
         "masked_combine": (_P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int)}
#: ``--fmad=false``: ``v - codes*step`` must never become an FMA, so the LAQ
#: payload/residual equal the plain version bit for bit
LIBRARY = build.CudaLibrary(
    "fastpath", Path(__file__).resolve().parent / "csrc"
    / "fastpath_kernels.cu",
    {entry: _ARGS[k] for k, v in ENTRIES.items() for entry in v.values()},
    extra_flags=("--fmad=false",))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(kernel: str, *dtypes: torch.dtype) -> str:
    """The C entry of ``kernel`` for these operand dtypes; raises for a
    combination with no instantiation (there is no widening fallback)."""
    entry = ENTRIES[kernel].get(dtypes)
    if entry is None:
        raise TypeError(f"{kernel}: no instantiation for operand dtypes "
                        f"{tuple(str(d) for d in dtypes)}; built: "
                        f"{[tuple(str(d) for d in k) for k in ENTRIES[kernel]]}")
    return entry


def _launch(kernel: str, dtypes, *args, device) -> None:
    """Launch ``kernel``'s instantiation for ``dtypes``, counted in
    ``LAUNCHES`` under its name."""
    entry = _entry(kernel, *dtypes)
    if device.type == "meta":
        return
    build.launch(getattr(build.load(LIBRARY), entry), *args, device=device)
    LAUNCHES[kernel + SUFFIX[dtypes]] += 1


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------

def _check(name: str, x: torch.Tensor, ndims=(3,),
           dtypes=(_F32, _BF16, _F16)) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: one of {[str(d) for d in dtypes]} "
                        f"required, got {x.dtype}")
    if x.dim() not in ndims or x.shape[-1] != LANES \
            or x.shape[-2] % SUB_ROWS:
        raise ValueError(f"{name}: want (W, R, {LANES}) with R % {SUB_ROWS}"
                         f" == 0, got {tuple(x.shape)}")
    if x.is_cuda and (not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{name}: CUDA operand must be contiguous and "
                         f"16-byte aligned")


def _same_device(*xs: torch.Tensor) -> bool:
    """True where the wrapper takes its kernel's route: CUDA tensors, and
    meta tensors (outputs allocated, nothing launched: the dry-run's
    reckoning of the card's memory); False on the CPU (the plain
    version)."""
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"operands on different devices: "
                         f"{[str(x.device) for x in xs]}")
    return dev.type in ("cuda", "meta")


# ---------------------------------------------------------------------------
# The five kernels
# ---------------------------------------------------------------------------

def delta_sqnorm_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sub-block partials of ‖a − b‖²: (W, R, L) × (W|·, R, L) →
    (W, R/8) float32.  ``b`` may be the unstacked (R, L) shared tree."""
    _check("a", a)
    _check("b", b, (2, 3))
    if b.shape[-2:] != a.shape[-2:] or (b.dim() == 3
                                         and b.shape[0] != a.shape[0]):
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    dts = (a.dtype, b.dtype)
    _entry("delta_sqnorm_blocks", *dts)
    if not _same_device(a, b):
        return kernels_ref.delta_sqnorm_blocks(a, b)
    W, R = a.shape[0], a.shape[1]
    out = torch.empty((W, R // SUB_ROWS), dtype=torch.float32,
                      device=a.device)
    vec = R * LANES // 4
    _launch("delta_sqnorm_blocks", dts, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), W, R // SUB_ROWS, vec,
            vec if b.dim() == 3 else 0, device=a.device)
    return out


def sqnorm_blocks(a: torch.Tensor) -> torch.Tensor:
    """Per-sub-block partials of ‖a‖²: (W, R, L) float32, bfloat16 or
    float16 → (W, R/8) float32."""
    _check("a", a)
    if not _same_device(a):
        return kernels_ref.sqnorm_blocks(a)
    W, R = a.shape[0], a.shape[1]
    out = torch.empty((W, R // SUB_ROWS), dtype=torch.float32,
                      device=a.device)
    _launch("sqnorm_blocks", (a.dtype,), a.data_ptr(), out.data_ptr(),
            W * (R // SUB_ROWS), device=a.device)
    return out


def _check_laq(g, q, e) -> Tuple[torch.dtype, torch.dtype]:
    for n, x in (("g", g), ("q", q)):
        _check(n, x)
    _check("e", e, dtypes=(_F32,))
    if not (g.shape == q.shape == e.shape):
        raise ValueError("LAQ operand shapes differ: "
                         f"{[tuple(x.shape) for x in (g, q, e)]}")
    return g.dtype, q.dtype


def absmax_blocks(g: torch.Tensor, q: torch.Tensor,
                  e: torch.Tensor) -> torch.Tensor:
    """Per-sub-block max|(g − q) + e| — the LAQ quantizer-scale sweep; the
    residual ``e`` is float32."""
    dts = _check_laq(g, q, e)
    _entry("absmax_blocks", *dts)
    if not _same_device(g, q, e):
        return kernels_ref.absmax_blocks(g, q, e)
    W, R = g.shape[0], g.shape[1]
    out = torch.empty((W, R // SUB_ROWS), dtype=torch.float32,
                      device=g.device)
    _launch("absmax_blocks", dts, g.data_ptr(), q.data_ptr(), e.data_ptr(),
            out.data_ptr(), W * (R // SUB_ROWS), device=g.device)
    return out


def laq_encode_blocks(g: torch.Tensor, q: torch.Tensor, e: torch.Tensor,
                      steps_subs: torch.Tensor, bits: int,
                      payload_out: Optional[torch.Tensor] = None):
    """Fused b-bit encode over the batched flat buffer → (payload (W, R, L),
    residual (W, R, L), Σ payload² per sub-block (W, R/8)), all float32.

    ``steps_subs`` is the (W, R/8) per-sub-block quantizer step, already
    divided by qmax.  ``payload_out`` (a float32 buffer; may be a float32
    ``g`` itself) receives the payload instead of a new buffer.
    """
    dts = _check_laq(g, q, e)
    _entry("laq_encode_blocks", *dts)
    W, R = g.shape[0], g.shape[1]
    if steps_subs.shape != (W, R // SUB_ROWS) \
            or steps_subs.dtype != torch.float32:
        raise ValueError(f"steps_subs: want float32 {(W, R // SUB_ROWS)}, "
                         f"got {steps_subs.dtype} {tuple(steps_subs.shape)}")
    if payload_out is not None:
        _check("payload_out", payload_out, dtypes=(_F32,))
        if payload_out.shape != g.shape:
            raise ValueError("payload_out: shape differs from g")
    if not _same_device(g, q, e, steps_subs):
        p, r, sq = kernels_ref.laq_encode_blocks(g, q, e, steps_subs, bits)
        if payload_out is not None:
            p = payload_out.copy_(p)
        return p, r, sq
    steps_subs = steps_subs.contiguous()
    p = torch.empty_like(e) if payload_out is None else payload_out
    r = torch.empty_like(e)
    sq = torch.empty((W, R // SUB_ROWS), dtype=torch.float32,
                     device=g.device)
    _launch("laq_encode_blocks", dts, g.data_ptr(), q.data_ptr(),
            e.data_ptr(), steps_subs.data_ptr(), p.data_ptr(), r.data_ptr(),
            sq.data_ptr(), W * (R // SUB_ROWS), float(2 ** (bits - 1) - 1),
            device=g.device)
    return p, r, sq


def masked_combine(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                   mode: str, out: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Per-worker masked fold of candidate ``a`` into state ``b``, computed
    in float32 and written at ``b``'s dtype.

    ``mask`` is (W,) bool/float; ``mode`` ∈ ``MASK_MODES``.  ``select``
    copies bit-exactly (``a`` and ``b`` of one dtype).  ``a`` may be
    unstacked (R, L).  ``out`` (may be ``b`` itself, for an in-place state
    update) receives the result.
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
        _check("out", out, dtypes=(b.dtype,))
        if out.shape != b.shape:
            raise ValueError("out: shape differs from b")
    dts = (a.dtype, b.dtype)
    _entry("masked_combine", *dts)
    if not _same_device(a, b, mask):
        res = kernels_ref.masked_combine(a, b, mask, mode)
        return res if out is None else out.copy_(res)
    m = mask.to(torch.float32).contiguous()
    res = torch.empty_like(b) if out is None else out
    vec = R * LANES // 4
    _launch("masked_combine", dts, a.data_ptr(), b.data_ptr(), m.data_ptr(),
            res.data_ptr(), W, vec, vec if a.dim() == 3 else 0,
            MASK_MODES.index(mode), device=b.device)
    return res
