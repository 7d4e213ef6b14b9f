"""The RMSNorm kernel's fold order (``csrc/rmsnorm.cu``), emulated in numpy.

A row belongs to a team of W warps, W the least of 1, 2, 4, 8 with
128 W >= its chunks of eight elements (d alone sets it, whatever the
dtype).  Thread t of the team takes the chunks t, t + 32 W, ... and folds
their elements in order with fmaf, then each warp runs its xor butterfly
(16, 8, 4, 2, 1), then the team adds its warp sums in warp order; the mean
square is sum / d + eps in float32.  fmaf is a float64 product (exact for
float32 operands) and a sum rounded to float32.

No JAX here: ``tests/test_torch_kernels.py`` holds the emulation against
the reference on the CPU, ``tests/test_torch_rmsnorm_cuda.py`` holds the
kernel against it bit for bit on the card.
"""
import numpy as np
import torch

RMS_WIDTHS = (4, 132, 1024, 2048, 3072, 3584, 4096, 6000, 8192)


def kernel_team_warps(d: int) -> int:
    chunks, w = -(-d // 8), 1
    while w < 8 and 128 * w < chunks:
        w *= 2
    return w


def kernel_mean_square(x: torch.Tensor, eps: float = 1e-6) -> np.ndarray:
    """x (R, d) float32 or 2-byte → the kernel's sum / d + eps per row,
    float32 (a 2-byte row widened first)."""
    R, d = x.shape
    W = kernel_team_warps(d)
    T = 32 * W
    K = -(-(-(-d // 8)) // T)                    # chunks a thread
    v = np.zeros((R, K * T * 8), np.float64)     # zeros fold as no-ops
    v[:, :d] = x.float().numpy()                 # each chunk widened
    v = v.reshape(R, K, T, 8)                    # chunk k·T + t of thread t
    acc = np.zeros((R, T), np.float32)
    for k in range(K):
        for e in range(8):
            acc = (v[:, k, :, e] * v[:, k, :, e] + acc).astype(np.float32)
    acc = acc.reshape(R, W, 32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, np.arange(32) ^ o]
    tot = acc[:, 0, 0]
    for w in range(1, W):
        tot = tot + acc[:, w, 0]
    return tot / np.float32(d) + np.float32(eps)


def kernel_rsqrt(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The rsqrt of ``kernel_mean_square``, rounded once to float32 (the
    card's ``rsqrtf`` is within an ulp of it): (R, 1) float32."""
    ms = kernel_mean_square(x, eps).astype(np.float64)
    return torch.from_numpy((1.0 / np.sqrt(ms)).astype(np.float32))[:, None]


def kernel_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """The kernel's output for the rsqrt ``r`` (R, 1) float32:
    y = T(T(x · r) · T(scale)), T = x's dtype."""
    return ((x.float() * r).to(x.dtype).float()
            * scale.to(x.dtype).float()).to(x.dtype)


# The rows kernel (``rmsnorm_rows_kernel``: rows the TMA stream does not
# take, any d, any alignment) folds in the stream's order, fixed by d alone:
# each chunk of eight is read from shared memory at whatever element offset
# the row lies, so neither the alignment nor the dtype moves the bits (rows
# past 8192 elements: W = 8, more than four chunks a thread; past 24576 the
# two-pass kernel, a block of eight warps a row, the same order).
RMS_ROWS_WIDTHS = (1, 3, 17, 4099, 8200, 16384, 20000)


def rows_mean_square(x: torch.Tensor, eps: float = 1e-6) -> np.ndarray:
    """x (R, d) float32 or 2-byte → the rows kernel's sum / d + eps per
    row, float32: ``kernel_mean_square`` at any d."""
    return kernel_mean_square(x, eps)
