"""Fused RMSNorm on Hopper: the launch of ``csrc/rmsnorm.cu`` (port of the
Pallas kernel ``repro.kernels.rmsnorm.rmsnorm.rmsnorm_2d``).

The CUDA kernel takes any number of rows (no row padding), float32 or
bfloat16, and widths that are a multiple of 4 up to ``MAX_D``: a row lives
in one warp's registers up to 4096 and in one block's (256 threads) up to
8192.  The output is at x's dtype and the scale is cast to it first, as in
the reference's kernel (so a bfloat16 x with a float32 scale writes
bfloat16, where the plain version promotes to float32).  ``LAUNCHES``
counts the launches of each instantiation (``rmsnorm`` for float32,
``rmsnorm_bf16`` for bfloat16); nothing else increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import build

#: the widest row the kernel takes (8 groups of 4 a thread of a row's block)
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


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *,
               eps: float = 1e-6) -> torch.Tensor:
    """x (R, d) float32 or bfloat16, scale (d,) at x's dtype or float32,
    on one CUDA device → (R, d) at x's dtype."""
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
    name, entry = ENTRIES[x.dtype]
    y = torch.empty_like(x)
    build.launch(getattr(build.load(LIBRARY), entry), x.data_ptr(),
                 scale.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                 float(eps), device=x.device)
    LAUNCHES[name] += 1
    return y
