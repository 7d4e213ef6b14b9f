"""The float16 instantiations and the two new kernel paths on the card, held
to their plain versions.

Every test here needs a CUDA device (``cuda`` marker; they skip without
one).  The file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_f16_cuda.py

- Kernels 1-5 (the plane) and 8-12 (the legacy route) at (f16, f16) and
  (f32, f16) operands, kernel 5 at bfloat16 too, on inputs that reach
  float16's subnormals and ±65504: masked folds, maxima and LAQ payloads and
  residuals bitwise the plain version, sums within rtol 1e-5 of it, and
  every output bitwise the float32 kernel on the widened operands (one
  element-to-thread map and fold order in every dtype).
- Kernel 6: the float16 stream bitwise the float32 kernel's row rounded
  twice; the rows kernel (d 1 to 20000 at element offsets 0 to 3, and
  the two-pass kernel past 24576) in all three dtypes bit for bit
  ``rmsnorm_fold.rows_mean_square``'s fold through the card's rsqrt, the
  2-byte rows bitwise the float32 kernel's on the aligned widened row
  rounded twice, float32 within 1e-5 of the plain version; at widths the
  stream takes, one to three elements off, bitwise the stream's output.
- Kernel 7: the float16 tensor-core kernel within one float16 ulp (+ 1e-6)
  of the plain version on the widened inputs, rounded, on ragged cases and
  on the dominant-key rows; the wide kernel (head_dim 257 to 600: both
  instantiations, the padding to 8 and the slabs above 512) in all three
  dtypes, float32 within 1e-5, a 2-byte dtype within one ulp.
- Each instantiation is counted under its own name in ``LAUNCHES``.
"""
import numpy as np
import pytest
import torch

from cuda_helpers import cuda_device  # noqa: F401 (a fixture)
from repro_torch.fastpath import kernels as fp
from repro_torch.fastpath import kernels_ref as fp_ref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.lag_trigger import lag_trigger as lt
from repro_torch.kernels.lag_trigger import ref as lt_ref
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rms

from rmsnorm_fold import RMS_ROWS_WIDTHS, kernel_rmsnorm, rows_mean_square

SUM_RTOL = 1e-5
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
PAIRS = [(F16, F16), (F32, F16)]
PAIR_IDS = ["hh", "fh"]


def edged(shape, seed, device, scale=1.0) -> torch.Tensor:
    """Normal float32 values with float16's edges (its subnormals, about
    2^-24, ±65504), on ``device``."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) \
        * scale
    v = x.view(-1)
    v[::97] *= 1e-5
    v[5::101] = 3e-8
    v[7::103] = 65504.0
    v[11::211] = -65504.0
    return x.to(device)


def f16_ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.clamp(e, min=-13) - 11)


def ulp_of(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == F16:
        return f16_ulp(x)
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


# ---------------------------------------------------------------------------
# Kernels 1-5
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("W,R", [(1, 8), (3, 264), (2, 2048)])
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_cuda_plane_f16_instantiations(cuda_device, pair, W, R):
    a = edged((W, R, 128), W * R, cuda_device).to(pair[0])
    b = edged((W, R, 128), W * R + 1, cuda_device, 0.5).to(pair[1])
    e = edged((W, R, 128), W * R + 2, cuda_device, 0.01)
    sfx = "_hh" if pair[0] == F16 else "_fh"
    fp.reset_launches()
    for bb in ((b, b[0]) if pair[0] == pair[1] else (b,)):
        got = fp.delta_sqnorm_blocks(a, bb)
        assert torch.equal(got, fp.delta_sqnorm_blocks(a.float(),
                                                       bb.float()))
        torch.testing.assert_close(got.cpu(), fp_ref.delta_sqnorm_blocks(
            a.cpu(), bb.cpu()), rtol=SUM_RTOL, atol=0)
    got = fp.absmax_blocks(a, b, e)
    assert torch.equal(got, fp.absmax_blocks(a.float(), b.float(), e))
    assert torch.equal(got.cpu(), fp_ref.absmax_blocks(a.cpu(), b.cpu(),
                                                       e.cpu()))
    steps = got / torch.full_like(got, 7.0)
    out = fp.laq_encode_blocks(a, b, e, steps, 4)
    want = fp_ref.laq_encode_blocks(a.cpu(), b.cpu(), e.cpu(), steps.cpu(),
                                    4)
    wide = fp.laq_encode_blocks(a.float(), b.float(), e, steps, 4)
    assert torch.equal(out[0].cpu(), want[0])
    assert torch.equal(out[1].cpu(), want[1])
    torch.testing.assert_close(out[2].cpu(), want[2], rtol=SUM_RTOL, atol=0)
    for x, y in zip(out, wide):
        assert torch.equal(x, y)
    mask = torch.tensor([True, False, True][:W], device=cuda_device)
    for mode in fp.MASK_MODES:
        if mode == "select" and pair[0] != pair[1]:
            continue
        got = fp.masked_combine(a, b, mask, mode)
        assert got.dtype == F16
        assert torch.equal(got.cpu(), fp_ref.masked_combine(
            a.cpu(), b.cpu(), mask.cpu(), mode))
        assert torch.equal(got, fp.masked_combine(
            a.float(), b.float(), mask, mode).half())
    launched = {k for k, v in fp.LAUNCHES.items() if v}
    assert launched == {k + sfx for k in ("delta_sqnorm_blocks",
                                          "absmax_blocks",
                                          "laq_encode_blocks",
                                          "masked_combine")} | {
        "delta_sqnorm_blocks", "absmax_blocks", "laq_encode_blocks",
        "masked_combine"}


@pytest.mark.cuda
@pytest.mark.parametrize("W,R", [(1, 8), (3, 264), (2, 40000)])
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "f16"])
def test_cuda_sqnorm_blocks_2byte(cuda_device, dtype, W, R):
    """Kernel 5 at 2 bytes (16-byte loads, lane pairs swapping 8 bytes):
    one sub-block, a partial last block, many blocks: bitwise the float32
    kernel on the widened operand, within rtol 1e-5 of the plain
    version."""
    a = edged((W, R, 128), 5 + W * R, cuda_device).to(dtype)
    fp.reset_launches()
    got = fp.sqnorm_blocks(a)
    assert torch.equal(got, fp.sqnorm_blocks(a.float()))
    torch.testing.assert_close(got.cpu(), fp_ref.sqnorm_blocks(a.cpu()),
                               rtol=SUM_RTOL, atol=0)
    name = "sqnorm_blocks" + ("_f16" if dtype == F16 else "_bf16")
    assert fp.LAUNCHES[name] == 1


# ---------------------------------------------------------------------------
# Kernels 8-12
# ---------------------------------------------------------------------------

def card(x: torch.Tensor, dtype, offset: int, device) -> torch.Tensor:
    buf = torch.zeros((x.numel() + offset,), dtype=dtype, device=device)
    buf[offset:].copy_(x)
    return buf[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_cuda_legacy_f16_instantiations(cuda_device, pair):
    sfx = "_hh" if pair[0] == F16 else "_fh"
    for n in (1, 3, 127, 1000, 257 * 33, 32769):
        for offset in (0, 1):
            xs = [edged((n,), n + i, "cpu", sc)
                  for i, sc in enumerate((1.0, 0.5, 0.01))]
            a, b = card(xs[0], pair[0], offset, cuda_device), \
                card(xs[1], pair[1], offset, cuda_device)
            e = card(xs[2], F32, offset, cuda_device)
            wa, wb = card(a.float(), F32, offset, cuda_device), \
                card(b.float(), F32, offset, cuda_device)
            lt.reset_launches()
            got = lt.delta_sqnorm_2d(a, b)
            assert torch.equal(got, lt.delta_sqnorm_2d(wa, wb))
            torch.testing.assert_close(got, lt_ref.delta_sqnorm(a, b),
                                       rtol=SUM_RTOL, atol=0)
            m = torch.ones((), device=cuda_device)
            got = lt.masked_update_2d(a, b, m * 0.5)
            assert torch.equal(got, lt_ref.masked_lazy_update(a, b, 0.5))
            assert torch.equal(got, lt.masked_update_2d(wa, wb,
                                                        m * 0.5).half())
            s = lt.innovation_absmax_2d(a, b, e)
            assert torch.equal(s, lt_ref.innovation_absmax(a, b, e))
            assert torch.equal(s, lt.innovation_absmax_2d(wa, wb, e))
            p, r, sq = lt.laq_encode_2d(a, b, e, s, 4)
            wp, wr, wsq = lt_ref.laq_encode(a, b, e, s, 4)
            assert torch.equal(p, wp) and torch.equal(r, wr)
            torch.testing.assert_close(sq, wsq, rtol=SUM_RTOL, atol=0)
            xp, xr, xsq = lt.laq_encode_2d(wa, wb, e, s, 4)
            assert torch.equal(p, xp) and torch.equal(r, xr) \
                and torch.equal(sq, xsq)
            if pair[0] == F16:
                got = lt.sqnorm_2d(a)
                assert torch.equal(got, lt.sqnorm_2d(wa))
                torch.testing.assert_close(got, lt_ref.sqnorm(a),
                                           rtol=SUM_RTOL, atol=0)
            want = {k + sfx for k in ("delta_sqnorm_2d", "masked_update_2d",
                                      "innovation_absmax_2d",
                                      "laq_encode_2d")}
            if pair[0] == F16:
                want.add("sqnorm_2d_f16")
            assert {k for k, v in lt.LAUNCHES.items() if v} - {
                "delta_sqnorm_2d", "masked_update_2d", "innovation_absmax_2d",
                "laq_encode_2d", "sqnorm_2d"} == want


# ---------------------------------------------------------------------------
# Kernel 6: the float16 stream and the rows kernel
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", (132, 2048, 6000, 8192))
def test_cuda_rmsnorm_f16_stream(cuda_device, d):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((1000, d), device=cuda_device, generator=g).half()
    s = torch.randn((d,), device=cuda_device, generator=g).half()
    rms.reset_launches()
    got = rms.rmsnorm_2d(x, s)
    assert rms.LAUNCHES["rmsnorm_f16"] == 1
    y32 = rms.rmsnorm_2d(x.float(), torch.ones(d, device=cuda_device))
    assert torch.equal(got, (y32.half().float() * s.float()).half())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1, 2, 3))
@pytest.mark.parametrize("dtype", (F32, BF16, F16),
                         ids=("f32", "bf16", "f16"))
@pytest.mark.parametrize("d", RMS_ROWS_WIDTHS)
def test_cuda_rmsnorm_rows_kernel(cuda_device, d, dtype, offset):
    """The rows kernel folds as ``rows_mean_square`` (the stream's order,
    by d alone) at any element offset, on the path ``rms.rows_path`` names
    (the ring written back by bulk stores where x is aligned, by element
    elsewhere, as ``rms.rows_counts`` shows), bit for bit through the
    card's rsqrt; 2-byte rows are the float32 rows kernel's on the widened
    row (aligned) rounded twice; float32 within 1e-5 of the plain
    version."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((16, d)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    x, s = x.to(dtype), s.to(dtype)
    xs = card(x.reshape(-1), dtype, offset, cuda_device).view(16, d)
    ss = card(s, dtype, offset, cuda_device)
    rms.reset_launches()
    path = rms.ROWS_PATHS.index(rms.rows_path(xs))
    assert path == (0 if offset == 0 else 1)
    loads = rms.rows_counts()[dtype]
    got = rms.rmsnorm_2d(xs, ss)
    assert not rms.stream_takes(xs, ss)
    assert rms.LAUNCHES[rms.ROWS_ENTRIES[dtype][0]] == 1
    now = rms.rows_counts()[dtype]          # one launch, on that path
    assert [a - b for a, b in zip(now, loads)] == [int(i == path)
                                                   for i in range(3)]
    ms = torch.from_numpy(rows_mean_square(x)).to(cuda_device)
    want = kernel_rmsnorm(x, s, torch.rsqrt(ms)[:, None].cpu())
    assert torch.equal(got.cpu(), want)
    if dtype == F32:
        torch.testing.assert_close(got, rms_ref.rmsnorm(xs, ss),
                                   rtol=1e-5, atol=1e-5)
    else:
        y32 = rms.rmsnorm_2d(x.float().to(cuda_device),
                             torch.ones(d, device=cuda_device))
        assert torch.equal(got, (y32.to(dtype).float()
                                 * ss.float()).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (1, 2, 3))
@pytest.mark.parametrize("dtype", (F32, BF16, F16),
                         ids=("f32", "bf16", "f16"))
@pytest.mark.parametrize("d", (132, 2048, 6000, 8192))
def test_cuda_rmsnorm_rows_kernel_is_the_stream_unaligned(cuda_device, d,
                                                          dtype, offset):
    """A width the stream takes, at an element offset it does not: the
    rows kernel's output bitwise the stream kernel's on an aligned copy
    (one fold order), and a 2-byte row's bitwise the float32 stream's on
    the widened row rounded twice."""
    g = torch.Generator(device=cuda_device).manual_seed(d + offset)
    x = torch.randn((100, d), device=cuda_device, generator=g).to(dtype)
    s = torch.randn((d,), device=cuda_device, generator=g).to(dtype)
    xs = card(x.reshape(-1), dtype, offset, cuda_device).view(100, d)
    ss = card(s, dtype, offset, cuda_device)
    rms.reset_launches()
    got = rms.rmsnorm_2d(xs, ss)
    assert rms.LAUNCHES[rms.ROWS_ENTRIES[dtype][0]] == 1
    assert torch.equal(got, rms.rmsnorm_2d(x, s))
    assert rms.LAUNCHES[rms.ENTRIES[dtype][0]] == 1
    if dtype != F32:
        y32 = rms.rmsnorm_2d(x.float(), torch.ones(d, device=cuda_device))
        assert rms.LAUNCHES["rmsnorm"] == 1
        assert torch.equal(got, (y32.to(dtype).float() * s.float()).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("dtype", (F32, BF16, F16),
                         ids=("f32", "bf16", "f16"))
@pytest.mark.parametrize("rows,d", [(3000, 4099), (600, 20000)])
def test_cuda_rmsnorm_rows_kernel_wraps_the_ring(cuda_device, rows, d,
                                                 dtype, offset):
    """Enough rows that every block's tiles wrap its ring (up to d 8192 two
    blocks a SM of 112 KB, beyond one of 224 KB): bit for bit the fold."""
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    x, s = x.to(dtype), s.to(dtype)
    xs = card(x.reshape(-1), dtype, offset, cuda_device).view(rows, d)
    got = rms.rmsnorm_2d(xs, card(s, dtype, offset, cuda_device))
    ms = torch.from_numpy(rows_mean_square(x)).to(cuda_device)
    assert torch.equal(got.cpu(), kernel_rmsnorm(
        x, s, torch.rsqrt(ms)[:, None].cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (F32, BF16, F16),
                         ids=("f32", "bf16", "f16"))
@pytest.mark.parametrize("d", (24577, 40000))
def test_cuda_rmsnorm_rows_two_pass(cuda_device, d, dtype):
    """Rows too wide for the ring: the two-pass kernel, the same fold."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    x, s = x.to(dtype), s.to(dtype)
    assert rms.rows_path(x) == "two_pass"
    loads = rms.rows_counts()[dtype]
    got = rms.rmsnorm_2d(x.to(cuda_device), s.to(cuda_device))
    assert rms.rows_counts()[dtype][2] == loads[2] + 1
    ms = torch.from_numpy(rows_mean_square(x)).to(cuda_device)
    assert torch.equal(got.cpu(), kernel_rmsnorm(
        x, s, torch.rsqrt(ms)[:, None].cpu()))


# ---------------------------------------------------------------------------
# Kernel 7: float16 and the wide kernel
# ---------------------------------------------------------------------------

def attn(shape_q, shape_kv, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape_q, device=device, generator=g).to(dtype),
            torch.randn(shape_kv, device=device, generator=g).to(dtype),
            torch.randn(shape_kv, device=device, generator=g).to(dtype))


def within_one_ulp(got, q, k, v, causal, window):
    want = fa_ref.attention(q.float(), k.float(), v.float(), causal=causal,
                            window=window).to(got.dtype).float()
    S, Skv = q.shape[1], k.shape[1]
    g = got.float()
    if S > Skv and window is not None:
        live = torch.arange(S, device=q.device) - window + 1 < Skv
        g, want = g[:, live], want[:, live]
    bound = ulp_of(torch.maximum(g.abs(), want.abs()), got.dtype) + 1e-6
    return bool(((g - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hd,H,KV", [(64, 8, 2), (80, 4, 4), (128, 8, 2),
                                     (256, 4, 1), (32, 4, 2)])
@pytest.mark.parametrize("S,Skv,causal,window", [
    (1, 1, True, None), (65, 65, True, None), (129, 129, True, 64),
    (200, 200, False, None), (129, 1000, True, None), (1000, 129, True, 64),
    (300, 300, True, None), (97, 500, False, 40), (130, 65, True, 100),
    (64, 129, False, 16)])
def test_cuda_flash_f16(cuda_device, hd, H, KV, S, Skv, causal, window):
    q, k, v = attn((1, S, H, hd), (1, Skv, KV, hd), F16, cuda_device,
                   S * hd + Skv)
    fa.reset_launches()
    got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert got.dtype == F16 and fa.LAUNCHES["flash_attention_f16"] == 1
    assert within_one_ulp(got, q, k, v, causal, window)


@pytest.mark.cuda
def test_cuda_flash_f16_dominant_key_rows(cuda_device):
    """Every weight but key 0's about 1.5e-8, below float16's 2^-24: the
    scaled split keeps them (the output, about 1.5e-5 at the last row)."""
    S, hd = 2048, 64
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.zeros((1, S, 2, hd), device=cuda_device)
    q[..., 0] = 6.0
    k = torch.randn((1, S, 1, hd), device=cuda_device, generator=g) * 0.01
    k[:, 0, :, 0] = 24.0
    v = torch.rand((1, S, 1, hd), device=cuda_device, generator=g)
    v[:, 0] = 0.0
    q, k, v = q.half(), k.half(), v.half()
    got = fa.flash_attention_fwd(q, k, v, causal=True)
    assert float(got.float().abs().max()) > 1e-5
    assert within_one_ulp(got, q, k, v, True, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (F32, BF16, F16), ids=("f32", "bf16",
                                                         "f16"))
@pytest.mark.parametrize("hd", (257, 320, 384, 512, 600))
@pytest.mark.parametrize("S,Skv,causal,window", [
    (1, 1, True, None), (129, 129, True, None), (65, 65, True, 16),
    (129, 1000, False, None), (1000, 129, True, 64)])
def test_cuda_flash_wide(cuda_device, dtype, hd, S, Skv, causal, window):
    q, k, v = attn((1, S, 4, hd), (1, Skv, 2, hd), dtype, cuda_device,
                   S + Skv + hd)
    fa.reset_launches()
    got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert fa.LAUNCHES[fa.WIDE_ENTRIES[dtype][0]] == 1
    if dtype != F32:
        assert within_one_ulp(got, q, k, v, causal, window)
        return
    want = fa_ref.attention(q, k, v, causal=causal, window=window)
    if S > Skv and window is not None:
        live = torch.arange(S, device=q.device) - window + 1 < Skv
        got, want = got[:, live], want[:, live]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
