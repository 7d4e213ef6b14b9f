"""RMSNorm over any leading dims — port of ``repro.kernels.rmsnorm.ops``.

CPU tensors take the plain version (``ref.rmsnorm``); CUDA tensors the
hand-written kernel (``rmsnorm.rmsnorm_2d``), which needs no row padding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.rmsnorm import ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_2d


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    if not on_cuda(x):
        return ref.rmsnorm(x, scale, eps)
    d = x.shape[-1]
    return rmsnorm_2d(x.reshape(-1, d).contiguous(), scale.contiguous(),
                      eps=eps).reshape(x.shape)
