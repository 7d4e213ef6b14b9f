"""Fused RMSNorm on Hopper: the launch of ``csrc/rmsnorm.cu`` (port of the
Pallas kernel ``repro.kernels.rmsnorm.rmsnorm.rmsnorm_2d``).

The CUDA kernels take any number of rows (no row padding), float32,
bfloat16 or float16, and any width d >= 1, as the reference's kernel does.
The output is at x's dtype and the scale is cast to it first, as in the
reference's kernel (so a 2-byte x with a float32 scale writes x's dtype,
where the plain version promotes to float32).

Both kernels read x as contiguous rows: a non-contiguous x (a strided
view) is first copied to a contiguous one, and the rule below is applied to
the copy.  Two kernels, chosen by one rule (:func:`stream_takes`): a row
whose byte length is a multiple of 8 and of at most ``MAX_D`` elements,
with x and the scale 16-byte aligned, goes through the stream kernel (a
persistent grid streams tiles of rows through shared memory by TMA, and a
team of 1 to 8 warps, by d alone, folds each row): every row the models
give it.  Every other row (d 1, 3, 17, 4099, a contiguous x or scale whose
base is not 16-byte aligned, d above 8192) goes through the rows kernel:
the same persistent TMA design on each tile's 16-byte-aligned cover, the
row read from shared memory at any element offset and folded in the
stream's order, fixed by d alone (so a row's rsqrt does not depend on its
alignment); y written back by bulk stores where x's base is aligned, by
element elsewhere; rows past 24576 elements (or half the ring) read twice
through L2 by a block a row.  :func:`rows_counts` says which path each
launch took.  Neither falls back to the plain version.  ``LAUNCHES``
counts the launches of each instantiation (``rmsnorm``, ``rmsnorm_bf16``,
``rmsnorm_f16`` for the stream kernel, ``rmsnorm_rows``,
``rmsnorm_rows_bf16``, ``rmsnorm_rows_f16`` for the rows kernel); nothing
else increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: the widest row the stream kernel takes (a team of 8 warps, four chunks
#: of 8 elements a thread)
MAX_D = 8192

#: the stream kernel's instantiation of each dtype: (its name in
#: ``LAUNCHES``, entry point)
ENTRIES = {torch.float32: ("rmsnorm", "lag_rmsnorm_f32"),
           torch.bfloat16: ("rmsnorm_bf16", "lag_rmsnorm_bf16"),
           torch.float16: ("rmsnorm_f16", "lag_rmsnorm_f16")}
#: the rows kernel's
ROWS_ENTRIES = {torch.float32: ("rmsnorm_rows", "lag_rmsnorm_rows_f32"),
                torch.bfloat16: ("rmsnorm_rows_bf16",
                                 "lag_rmsnorm_rows_bf16"),
                torch.float16: ("rmsnorm_rows_f16", "lag_rmsnorm_rows_f16")}

#: kernel launches since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {name: 0 for table in (ENTRIES, ROWS_ENTRIES)
                            for name, _ in table.values()}

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_float)
LIBRARY = build.CudaLibrary(
    "rmsnorm", Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu",
    {entry: _ARGS for table in (ENTRIES, ROWS_ENTRIES)
     for _, entry in table.values()})
#: (dtype, stream?) → (its name in ``LAUNCHES``, the C function), at first
#: launch
_ENTRY: Dict[Tuple[torch.dtype, bool], Tuple[str, object]] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _refuse(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise on what the kernels do not take (device, dtype, shape), first
    failure first."""
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"rmsnorm_2d: CUDA operands on one device "
                         f"required, got {x.device} and {scale.device}")
    if x.dtype not in ENTRIES or scale.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"rmsnorm_2d: x float32, bfloat16 or float16 and "
                        f"scale at its dtype or float32 required, got "
                        f"{x.dtype} and {scale.dtype}")
    if x.dim() != 2 or scale.shape != (x.shape[1],) or x.shape[1] < 1:
        raise ValueError(f"rmsnorm_2d: want x (R, d) and scale (d,), d >= "
                         f"1, got {tuple(x.shape)} and {tuple(scale.shape)}")


def stream_takes(x: torch.Tensor, scale: torch.Tensor) -> bool:
    """The rule between the two kernels, on contiguous x and scale: the
    stream kernel takes a row of at most ``MAX_D`` elements whose byte
    length is a multiple of 8 (d a multiple of 4 in every dtype), with x
    and the scale 16-byte aligned; the rows kernel takes the rest."""
    d = x.shape[1]
    return (d % 4 == 0 and d <= MAX_D and x.data_ptr() % 16 == 0
            and scale.data_ptr() % 16 == 0)


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *,
               eps: float = 1e-6) -> torch.Tensor:
    """x (R, d) float32, bfloat16 or float16, scale (d,) at x's dtype or
    float32, on one CUDA device → (R, d) at x's dtype."""
    dtype = x.dtype
    # the common case's conditions at once, read as few times as can be
    if not (x.is_cuda and x.dim() == 2 and dtype in ENTRIES
            and scale.get_device() == x.get_device()
            and scale.dtype is dtype and scale.shape == x.shape[1:]
            and x.shape[1] >= 1):
        _refuse(x, scale)            # raises, or passes a float32 scale
        scale = scale.to(dtype)
    x, scale = x.contiguous(), scale.contiguous()
    stream = stream_takes(x, scale)
    name, fn = _ENTRY.get((dtype, stream)) or _resolve(dtype, stream)
    y = torch.empty_like(x)
    rows, d = x.shape
    build.launch(fn, x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
                 float(eps), device=x.device)
    LAUNCHES[name] += 1
    return y


def _resolve(dtype: torch.dtype, stream: bool):
    """(name, C entry point) of ``dtype``'s instantiation of one kernel,
    resolved once."""
    name, entry = (ENTRIES if stream else ROWS_ENTRIES)[dtype]
    _ENTRY[dtype, stream] = name, getattr(build.load(LIBRARY), entry)
    return _ENTRY[dtype, stream]


#: the rows kernel's paths, in the order ``rows_counts`` counts them: the
#: TMA ring writing y back by bulk stores (x's base 16-byte aligned, as
#: every ``torch.empty_like`` y is), the ring storing y by element (x's
#: base not aligned), the two-pass kernel for rows too wide for the ring
ROWS_PATHS = ("ring", "ring_by_element", "two_pass")


def rows_path(x: torch.Tensor) -> str:
    """The path the rows kernel takes for a contiguous x (R, d), as the
    library decides it (built if needed)."""
    fn = build.load(LIBRARY).lag_rmsnorm_rows_path
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return ROWS_PATHS[fn(x.shape[1], x.element_size(), x.data_ptr(), 0)]


def rows_counts() -> Dict[torch.dtype, Tuple[int, int, int]]:
    """The rows kernel's launches so far by dtype, one count per
    ``ROWS_PATHS`` entry, as the library counts them (built if needed;
    never reset)."""
    fn = build.load(LIBRARY).lag_rmsnorm_rows_counts
    fn.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    fn.restype = None
    out = (ctypes.c_int64 * 9)()
    fn(out)
    return {dt: tuple(out[3 * i:3 * i + 3]) for i, dt in enumerate(
        (torch.float32, torch.bfloat16, torch.float16))}


def plan(d: int, dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """The tiling a stream launch of rows of width ``d`` at ``dtype``
    picks, from the library itself (built if needed): (warps a row, rows a
    tile, stages a ring, blocks a SM)."""
    fn = build.load(LIBRARY).lag_rmsnorm_plan
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 4)()
    if fn(d, dtype.itemsize, out) != 0:
        raise ValueError(f"rmsnorm plan: no plan for d {d} at {dtype}")
    return tuple(out)

