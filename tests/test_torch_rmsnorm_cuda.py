"""The RMSNorm kernel on the card: its persistent walk, ring and alignment.

Every test here needs a CUDA device (``cuda`` marker; they skip without
one).  The file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rmsnorm_cuda.py

``csrc/rmsnorm.cu`` streams tiles of rows through a ring of shared-memory
stages, each block of a persistent grid walking every ``gridDim``-th tile.
The row counts below take one row, a part tile, one tile and a row, three
turns of every block's ring and a row, and 8193; the widths a ragged row
(d 132 and 6000, bfloat16 132 being 8 mod 16 bytes long) and a row of the
prefill.  float32 is held within 1e-5 of the plain version; bfloat16
bitwise to the float32 kernel's row on the widened input rounded twice, as
the reference's kernel rounds, and within the reference's 3e-2 of the plain
bfloat16 version.  The row counts come from the launch's own plan
(``rmsnorm.plan``).  At every width of ``rmsnorm_fold.RMS_WIDTHS`` the
kernel is held bit for bit to the emulation of its fold order that the CPU
tests hold against the reference.
"""
import numpy as np
import pytest
import torch

from cuda_helpers import cuda_device  # noqa: F401 (a fixture)
from repro_torch.kernels.rmsnorm import ops, ref
from repro_torch.kernels.rmsnorm import rmsnorm as rms

from rmsnorm_fold import (RMS_WIDTHS, kernel_mean_square, kernel_rmsnorm,
                          kernel_team_warps)

RMS_TOL = 1e-5
ROWS = ("1", "7", "tile+1", "3 rings+1", "8193")


def row_count(which: str, d: int, dtype, device) -> int:
    """``which`` of ROWS as a number of rows, from the launch's own plan."""
    _, tile, stages, per_sm = rms.plan(d, dtype)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"1": 1, "7": 7, "tile+1": tile + 1,
            "3 rings+1": 3 * stages * per_sm * sms * tile + 1,
            "8193": 8193}[which]


def check_kernel(x, s):
    got = ops.rmsnorm(x, s)
    assert got.dtype == x.dtype and got.shape == x.shape
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, ref.rmsnorm(x, s), rtol=RMS_TOL,
                                   atol=RMS_TOL)
        return got
    y32 = ops.rmsnorm(x.float(), torch.ones_like(s, dtype=torch.float32))
    assert torch.equal(got, (y32.bfloat16().float() * s.float()).bfloat16())
    plain = ref.rmsnorm(x, s).float()
    assert float((got.float() - plain).abs().max()) <= 3e-2 * max(
        1.0, float(plain.abs().max()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d", (1024, 132, 6000))
@pytest.mark.parametrize("which", ROWS)
def test_cuda_rmsnorm_walks_every_tile(cuda_device, which, d, dtype):
    dtype = getattr(torch, dtype)
    rows = row_count(which, d, dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(rows * d)
    x = torch.randn((rows, d), device=cuda_device, generator=g).to(dtype)
    s = torch.randn((d,), device=cuda_device, generator=g).to(dtype)
    check_kernel(x, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d", (132, 2048, 8192))
def test_cuda_rmsnorm_row_bits_do_not_depend_on_the_launch(cuda_device, d,
                                                           dtype):
    """A row alone and the same row inside an 8192-row launch come out bit
    for bit equal."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((8192, d), device=cuda_device, generator=g).to(dtype)
    s = torch.randn((d,), device=cuda_device, generator=g).to(dtype)
    whole = check_kernel(x, s)
    for j in (0, 1, 4097, 8191):
        alone = ops.rmsnorm(x[j:j + 1].clone(), s)
        assert torch.equal(alone, whole[j:j + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d", RMS_WIDTHS)
def test_cuda_rmsnorm_folds_as_the_emulation(cuda_device, d, dtype):
    """The kernel bit for bit against ``rmsnorm_fold``'s emulation of its
    fold order: the emulated mean square through the card's own float32
    rsqrt (``torch.rsqrt``), then the two roundings; the emulation's team
    width is the launch's."""
    dtype = getattr(torch, dtype)
    assert kernel_team_warps(d) == rms.plan(d, dtype)[0]
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    x, s = x.to(dtype), s.to(dtype)
    ms = torch.from_numpy(kernel_mean_square(x)).to(cuda_device)
    want = kernel_rmsnorm(x, s, torch.rsqrt(ms)[:, None].cpu())
    got = rms.rmsnorm_2d(x.to(cuda_device), s.to(cuda_device)).cpu()
    assert torch.equal(got, want)
