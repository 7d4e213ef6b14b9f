"""Plain PyTorch RMSNorm: the oracle of the CUDA kernel, and its route for
CPU tensors (port of ``repro.kernels.rmsnorm.ref``)."""
import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale
