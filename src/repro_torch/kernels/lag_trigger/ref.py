"""Plain PyTorch versions of the legacy per-leaf LAG-trigger kernels: the
oracle of ``csrc/lag_trigger.cu`` and its route for CPU tensors (port of
``repro.kernels.lag_trigger.ref``).  Every function casts each operand to
float32 inside, as the reference's Pallas kernels do, so it takes every
operand combination the kernels take (``lag_trigger.ENTRIES``: bfloat16
beside float32 too), and returns what the reference's function returns:
the sums and the LAQ payload and residual in float32, the masked update at
the old value's dtype, rounded once.
"""
import torch


def delta_sqnorm(g_new: torch.Tensor, g_old: torch.Tensor) -> torch.Tensor:
    """‖g_new − g_old‖² in float32 (flattened over all dims)."""
    d = g_new.float() - g_old.float()
    return torch.sum(d * d)


def masked_lazy_update(g_new, g_old, mask):
    """g_hat ← g_old + mask·(g_new − g_old); ``mask`` a () float/bool."""
    m = torch.as_tensor(mask, device=g_old.device).float()
    out = g_old.float() + m * (g_new.float() - g_old.float())
    return out.to(g_old.dtype)


def sqnorm(a: torch.Tensor) -> torch.Tensor:
    """‖a‖² in float32 (flattened over all dims)."""
    a32 = a.float()
    return torch.sum(a32 * a32)


def innovation_absmax(g, q, e) -> torch.Tensor:
    """max|(g − q) + e| in float32 — the LAQ quantizer scale.  An empty
    leaf gives −inf, the identity of the batched plane's per-leaf max."""
    v = (g.float() - q.float()) + e.float()
    if v.numel() == 0:
        return torch.full((), float("-inf"), device=v.device)
    return torch.amax(torch.abs(v))


def quantizer_step(scale: torch.Tensor, bits: int) -> torch.Tensor:
    """scale / (2^{b−1} − 1) as an IEEE float32 division.  The divisor is a
    tensor on the scale's device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead, which can differ in the
    last bit from the division the kernel makes."""
    scale = scale.float()
    return scale / torch.full_like(scale, float(2 ** (bits - 1) - 1))


def laq_encode(g, q, e, scale, bits: int):
    """b-bit symmetric uniform quantization of the error-compensated
    innovation v = (g − q) + e on the grid step = scale/(2^{b−1}−1).

    Returns (payload, new_residual, ‖payload‖²): payload is the dequantized
    Q_b(v), new_residual = v − Q_b(v).  scale == 0 (v ≡ 0) quantizes to
    zeros; ``inv`` is a zero-guarded IEEE 1/step and rounding is
    half-to-even, as the reference kernel.
    """
    qmax = float(2 ** (bits - 1) - 1)
    v = (g.float() - q.float()) + e.float()
    step = quantizer_step(scale, bits)
    pos = step > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, step, torch.ones_like(step)),
                      torch.zeros_like(step))
    codes = torch.clamp(torch.round(v * inv), -qmax, qmax)
    p = codes * step
    return p, v - p, torch.sum(p * p)
