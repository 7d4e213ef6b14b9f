"""Fused RMSNorm on Hopper: the launch of ``csrc/rmsnorm.cu`` (port of the
Pallas kernel ``repro.kernels.rmsnorm.rmsnorm.rmsnorm_2d``).

The CUDA kernel takes any number of rows (no row padding), float32, and
widths that are a multiple of 4 up to ``MAX_D``: a row lives in one warp's
registers up to 4096 and in one block's (256 threads) up to 8192.  ``LAUNCHES`` counts its launches;
nothing else increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import build

#: the widest row the kernel takes (8 float4s a thread of a row's block)
MAX_D = 8192

#: kernel launches since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

LIBRARY = build.CudaLibrary(
    "rmsnorm", Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu",
    {"lag_rmsnorm_f32": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int64, ctypes.c_int64, ctypes.c_float)})


def reset_launches() -> None:
    LAUNCHES["rmsnorm"] = 0


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *,
               eps: float = 1e-6) -> torch.Tensor:
    """x (R, d), scale (d,), both float32 on one CUDA device → (R, d)."""
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"rmsnorm_2d: CUDA operands on one device "
                         f"required, got {x.device} and {scale.device}")
    if x.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm_2d: float32 required, got {x.dtype} and "
                        f"{scale.dtype}")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_2d: want x (R, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.shape[1] % 4 or x.shape[1] > MAX_D:
        raise ValueError(f"rmsnorm_2d: width {x.shape[1]} not taken (a "
                         f"multiple of 4 up to {MAX_D})")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, scale)):
        raise ValueError("rmsnorm_2d: operands must be contiguous and "
                         "16-byte aligned")
    y = torch.empty_like(x)
    build.launch(build.load(LIBRARY).lag_rmsnorm_f32, x.data_ptr(),
                 scale.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                 float(eps), device=x.device)
    LAUNCHES["rmsnorm"] += 1
    return y
