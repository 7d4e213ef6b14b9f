"""Device resolution — the port's counterpart of ``repro.kernels.on_tpu``.

The reference asks the backend which device it runs on; the port takes the
device explicitly.  ``resolve_device("cuda")`` raises when no CUDA device is
present instead of carrying on on the CPU: the CPU is used only when the
caller asks for it.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(spec="cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) → device.

    Raises ``RuntimeError`` for a CUDA spec on a host without a CUDA device.
    """
    dev = torch.device(spec)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {spec!r} requested but torch.cuda.is_available() is "
            f"False; pass --device cpu (device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {spec!r}: use 'cuda' or 'cpu'")
    return dev


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (``--query-gpu=name,power.limit --format=csv,noheader``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
