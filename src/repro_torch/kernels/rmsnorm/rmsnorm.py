"""Fused RMSNorm on Hopper: the launch of ``csrc/rmsnorm.cu`` (port of the
Pallas kernel ``repro.kernels.rmsnorm.rmsnorm.rmsnorm_2d``).

The CUDA kernel takes any number of rows (no row padding), float32 or
bfloat16, and widths that are a multiple of 4 up to ``MAX_D``: a persistent
grid streams tiles of rows through shared memory by TMA, and a team of 1 to
8 warps (by d alone) folds each row.  The output is at x's dtype and the
scale is cast to it first, as in the reference's kernel (so a bfloat16 x
with a float32 scale writes bfloat16, where the plain version promotes to
float32).  ``LAUNCHES`` counts the launches of each instantiation
(``rmsnorm`` for float32, ``rmsnorm_bf16`` for bfloat16); nothing else
increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: the widest row the kernel takes (a team of 8 warps, four chunks of 8
#: elements a thread)
MAX_D = 8192

#: the instantiation of each dtype: (its name in ``LAUNCHES``, entry point)
ENTRIES = {torch.float32: ("rmsnorm", "lag_rmsnorm_f32"),
           torch.bfloat16: ("rmsnorm_bf16", "lag_rmsnorm_bf16")}

#: kernel launches since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {name: 0 for name, _ in ENTRIES.values()}

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_float)
LIBRARY = build.CudaLibrary(
    "rmsnorm", Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu",
    {entry: _ARGS for _, entry in ENTRIES.values()})
#: dtype → (its name in ``LAUNCHES``, the C function), at first launch
_ENTRY: Dict[torch.dtype, Tuple[str, object]] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _refuse(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise on what the kernel does not take, first failure first."""
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"rmsnorm_2d: CUDA operands on one device "
                         f"required, got {x.device} and {scale.device}")
    if x.dtype not in ENTRIES or scale.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"rmsnorm_2d: x float32 or bfloat16 and scale at "
                        f"its dtype or float32 required, got {x.dtype} and "
                        f"{scale.dtype}")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_2d: want x (R, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.shape[1] % 4 or x.shape[1] > MAX_D:
        raise ValueError(f"rmsnorm_2d: width {x.shape[1]} not taken (a "
                         f"multiple of 4 up to {MAX_D})")
    scale = scale.to(x.dtype)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, scale)):
        raise ValueError("rmsnorm_2d: operands must be contiguous and "
                         "16-byte aligned")


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *,
               eps: float = 1e-6) -> torch.Tensor:
    """x (R, d) float32 or bfloat16, scale (d,) at x's dtype or float32,
    on one CUDA device → (R, d) at x's dtype."""
    dtype = x.dtype
    # every condition of ``_refuse`` at once, read as few times as can be
    if not (x.is_cuda and x.dim() == 2 and dtype in ENTRIES
            and scale.get_device() == x.get_device()
            and scale.dtype is dtype and scale.shape == x.shape[1:]
            and x.shape[1] % 4 == 0 and x.shape[1] <= MAX_D
            and x.is_contiguous() and scale.is_contiguous()
            and x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0):
        _refuse(x, scale)            # raises, or passes a float32 scale
        scale = scale.to(dtype)
    name, fn = _ENTRY.get(dtype) or _resolve(dtype)
    y = torch.empty_like(x)
    rows, d = x.shape
    build.launch(fn, x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
                 float(eps), device=x.device)
    LAUNCHES[name] += 1
    return y


def _resolve(dtype: torch.dtype):
    """(name, C entry point) of ``dtype``'s instantiation, resolved once."""
    name, entry = ENTRIES[dtype]
    _ENTRY[dtype] = name, getattr(build.load(LIBRARY), entry)
    return _ENTRY[dtype]


def plan(d: int, dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """The tiling a launch of rows of width ``d`` at ``dtype`` picks, from
    the library itself (built if needed): (warps a row, rows a tile,
    stages a ring, blocks a SM)."""
    fn = build.load(LIBRARY).lag_rmsnorm_plan
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 4)()
    err = fn(d, dtype.itemsize, out)
    if err != 0:
        raise ValueError(f"rmsnorm plan: no plan for d {d} at {dtype}")
    return tuple(out)
