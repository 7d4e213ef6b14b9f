"""Hand-written CUDA kernels — port of ``repro.kernels``: RMSNorm and
flash attention for the model, and the legacy per-leaf ``lag_trigger``
kernels for the trainer's ``use_pallas_comm`` route.

Each kernel has a plain PyTorch version beside it (``ref.py``).  The
reference picks its route by backend (``on_tpu()``); the port picks it by
the tensor's device: an ``ops`` wrapper runs the plain version for CPU
tensors and launches the kernel for CUDA tensors, or raises.  The sources
are built by ``repro_torch.kernels.build``.
"""
import torch


def on_cuda(x: torch.Tensor) -> bool:
    """The port's ``on_tpu``: whether ``x`` takes the kernel route."""
    return x.is_cuda
