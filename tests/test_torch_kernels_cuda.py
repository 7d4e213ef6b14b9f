"""The model kernels (RMSNorm, flash attention) and the comm plane's
kernels 1-4 at bfloat16 operands on the card, held to their plain versions.

Every test here needs a CUDA device (``cuda`` marker; they skip without
one).  The file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

They were ``tests/test_torch_kernels.py``'s, whose JAX imports kept them
off the card's machine.  RMSNorm within ``RMS_TOL`` of its plain version
(float32), its bfloat16 kernel bitwise the float32 kernel's row rounded
twice; flash attention within ``ATTN_TOL`` (float32), the 2-byte kernels
within one ulp of the plain version on the widened inputs, rounded; the
wrappers' refusals; kernels 1-4's bfloat16 instantiations bitwise the
float32 kernels on the widened operands, and bitwise their plain versions
but for the sums (within rtol 1e-5: another summation order, as at
float32 and float16).
"""
import numpy as np
import pytest
import torch

from cuda_helpers import cuda_device  # noqa: F401 (a fixture)
from repro_torch.fastpath import kernels as fp_kernels
from repro_torch.fastpath import kernels_ref as fp_ref
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.kernels.rmsnorm import ops as t_rms_ops
from repro_torch.kernels.rmsnorm import ref as t_rms_ref

RMS_TOL = 1e-5
ATTN_TOL = 1e-5
SUM_RTOL = 1e-5      # a kernel's sums against the plain version's order


def attn_inputs(S, Skv, B=2, H=4, KV=2, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    return q, k, v


ATTN_CASES = [(S, S, causal, window)
              for S in (40, 72, 63, 64, 65, 129)
              for causal, window in ((True, None), (True, 16),
                                     (False, None))] + [
    (40, 72, False, None), (40, 72, True, None), (72, 40, True, 16),
    (129, 129, True, 100), (65, 130, True, None), (130, 65, True, 100),
    (64, 129, False, 16)]

WIDE_HEADS = (80, 128, 256)


def within_one_bf16_ulp(got, want) -> bool:
    """|got − want| ≤ one bfloat16 ulp of the larger + 1e-6, everywhere:
    the contract of the bfloat16 kernel against the reference's kernel on
    the widened inputs, rounded to bfloat16."""
    got, want = torch.from_numpy(np.asarray(got, np.float32)), \
        torch.from_numpy(np.asarray(want, np.float32))
    bound = bf16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-6
    return bool(((got - want).abs() <= bound).all())


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1, 2048), (13, 2048), (9, 256),
                                    (5, 132), (3, 4096), (7, 3072),
                                    (4, 3584), (6, 8192), (3, 6000)])
def test_cuda_rmsnorm_matches_plain(cuda_device, rows, d):
    g = torch.Generator(device=cuda_device).manual_seed(rows * d)
    x = torch.randn((rows, d), device=cuda_device, generator=g)
    s = torch.randn((d,), device=cuda_device, generator=g)
    torch.testing.assert_close(t_rms_ops.rmsnorm(x, s),
                               t_rms_ref.rmsnorm(x, s), rtol=RMS_TOL,
                               atol=RMS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("S,Skv,causal,window", ATTN_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, S, Skv, causal,
                                            window):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_inputs(S, Skv, H=8, KV=2))
    got = t_fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = t_fa_ref.attention(q, k, v, causal=causal, window=window)
    if S > Skv and window is not None:
        live = torch.arange(S, device=cuda_device) - window + 1 < Skv
        got, want = got[:, live], want[:, live]
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    with pytest.raises(RuntimeError, match="no backward"):
        t_fa_ops.flash_attention(q.requires_grad_(), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", WIDE_HEADS)
@pytest.mark.parametrize("S,Skv,causal,window", ATTN_CASES)
def test_cuda_flash_attention_matches_plain_wide_heads(cuda_device, S, Skv,
                                                       causal, window, hd):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_inputs(S, Skv, H=8, KV=2, hd=hd))
    got = t_fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = t_fa_ref.attention(q, k, v, causal=causal, window=window)
    if S > Skv and window is not None:
        live = torch.arange(S, device=cuda_device) - window + 1 < Skv
        got, want = got[:, live], want[:, live]
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1, 2048), (13, 2048), (9, 256),
                                    (5, 132), (3, 4096), (7, 3072),
                                    (4, 3584), (6, 8192), (3, 6000)])
def test_cuda_rmsnorm_bf16_matches_plain(cuda_device, rows, d):
    """The bfloat16 kernel is the float32 kernel's rsqrt on the widened row
    (same sum order) rounded twice, as the reference's kernel rounds:
    bitwise bf16(bf16(y32) · scale) with y32 the float32 kernel's output at
    scale 1; within the reference's 3e-2 of the plain bfloat16 version
    (× the output's largest |entry| above one: the reference states it for
    outputs of order one)."""
    g = torch.Generator(device=cuda_device).manual_seed(rows * d)
    x = torch.randn((rows, d), device=cuda_device, generator=g).bfloat16()
    s = torch.randn((d,), device=cuda_device, generator=g).bfloat16()
    got = t_rms_ops.rmsnorm(x, s)
    assert got.dtype == torch.bfloat16
    y32 = t_rms_ops.rmsnorm(x.float(), torch.ones(d, device=cuda_device))
    assert torch.equal(got, (y32.bfloat16().float() * s.float()).bfloat16())
    plain = t_rms_ref.rmsnorm(x, s).float()
    assert float((got.float() - plain).abs().max()) <= 3e-2 * max(
        1.0, float(plain.abs().max()))
    # a float32 scale is cast to x's dtype first, as in the reference
    assert torch.equal(t_rms_ops.rmsnorm(x, s.float()), got)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", (64,) + WIDE_HEADS)
@pytest.mark.parametrize("S,Skv,causal,window", ATTN_CASES)
def test_cuda_flash_attention_bf16_matches_plain(cuda_device, S, Skv, causal,
                                                 window, hd):
    """bfloat16 q, k, v: within one bfloat16 ulp of the plain version on
    the widened inputs rounded to bfloat16 (the reference kernel's
    function), and within the reference's 2.5e-2 of the plain bfloat16
    version (× the output's largest |entry| above one)."""
    q, k, v = (torch.from_numpy(a).to(cuda_device).bfloat16()
               for a in attn_inputs(S, Skv, H=8, KV=2, hd=hd))
    got = t_fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want = t_fa_ref.attention(q.float(), k.float(), v.float(),
                              causal=causal, window=window).bfloat16()
    plain = t_fa_ref.attention(q, k, v, causal=causal, window=window)
    if S > Skv and window is not None:
        live = torch.arange(S, device=cuda_device) - window + 1 < Skv
        got, want, plain = got[:, live], want[:, live], plain[:, live]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bf16_ulp(torch.maximum(got.float().abs(),
                                                want.float().abs()))
                 + 1e-6).all())
    assert float((got.float() - plain.float()).abs().max()) <= 2.5e-2 * max(
        1.0, float(plain.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("hd", (16, 32))
@pytest.mark.parametrize("S,Skv,causal,window", ATTN_CASES)
def test_cuda_flash_attention_at_zero_padded_head_dims(cuda_device, S, Skv,
                                                       causal, window, hd,
                                                       dtype):
    """head_dim 16 and 32 (the reference's own test cases) run the
    head_dim-64 instantiations on zero-padded operands with their true
    scale: float32 within ``ATTN_TOL`` of the plain version, bfloat16
    within one bfloat16 ulp (+ 1e-6) of it on the widened inputs, float16
    within one float16 ulp (+ 1e-6) of it with its P·V in float64."""
    q, k, v = (torch.from_numpy(a).to(cuda_device).to(getattr(torch, dtype))
               for a in attn_inputs(S, Skv, H=8, KV=2, hd=hd))
    got = t_fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == q.dtype
    wide = torch.float64 if dtype == "float16" else torch.float32
    want = t_fa_ref.attention(q.to(wide), k.to(wide), v.to(wide),
                              causal=causal, window=window).float()
    if S > Skv and window is not None:
        live = torch.arange(S, device=cuda_device) - window + 1 < Skv
        got, want = got[:, live], want[:, live]
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    elif dtype == "bfloat16":
        assert within_one_bf16_ulp(got.float().cpu(),
                                   want.bfloat16().float().cpu())
    else:
        g, w = got.float().cpu(), want.half().float().cpu()
        _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
        ulp = torch.ldexp(torch.ones_like(g), torch.clamp(e, min=-13) - 11)
        assert bool(((g - w).abs() <= ulp + 1e-6).all())


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_no_instantiation_serves(cuda_device):
    """float32, bfloat16 and float16 are taken at any head_dim (96 is
    zero-padded to 128, its output the plain version's; 257 and above take
    the wide kernel) and RMSNorm at any width (8196 and 1027 take the rows
    kernel); another dtype and mixed dtypes are refused."""
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_inputs(8, 8, B=1, hd=96))
    got = t_fa_ops.flash_attention(q, k, v)
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, t_fa_ref.attention(q, k, v),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    assert t_fa_ops.flash_attention(q.bfloat16(), k.bfloat16(),
                                    v.bfloat16()).shape == q.shape
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_inputs(8, 8, B=1, hd=257))
    torch.testing.assert_close(t_fa_ops.flash_attention(q, k, v),
                               t_fa_ref.attention(q, k, v), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    for dt in (torch.bfloat16, torch.half):
        assert t_fa_ops.flash_attention(q.to(dt), k.to(dt),
                                        v.to(dt)).dtype == dt
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_inputs(8, 8, B=1))
    assert t_fa_ops.flash_attention(q.half(), k.half(),
                                    v.half()).dtype == torch.half
    with pytest.raises(TypeError, match="float16"):
        t_fa_ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="one dtype"):
        t_fa_ops.flash_attention(q.bfloat16(), k, v)
    x = torch.ones((2, 8196), device=cuda_device)
    torch.testing.assert_close(t_rms_ops.rmsnorm(
        x, torch.ones(8196, device=cuda_device)), x, rtol=RMS_TOL,
        atol=RMS_TOL)
    for d in (1027, 8196):
        x = torch.ones((2, d), device=cuda_device, dtype=torch.bfloat16)
        assert t_rms_ops.rmsnorm(x, torch.ones(
            d, device=cuda_device, dtype=torch.bfloat16)).dtype \
            == torch.bfloat16
    x = torch.ones((2, 1024), device=cuda_device, dtype=torch.half)
    assert t_rms_ops.rmsnorm(x, torch.ones(1024, device=cuda_device,
                                           dtype=torch.half)).dtype \
        == torch.half
    with pytest.raises(TypeError, match="float16"):
        t_rms_ops.rmsnorm(x.double(), torch.ones(1024, device=cuda_device,
                                                 dtype=torch.double))


# ---------------------------------------------------------------------------
# The comm plane's kernels 1–4 at bfloat16 operands, on the card: bitwise
# their plain versions, and the partials bitwise the float32 kernel's on the
# widened operands (same element-to-lane map and sum order)
# ---------------------------------------------------------------------------

PLANE_COMBOS = [(k, dts) for k, table in fp_kernels.ENTRIES.items()
                for dts in table if torch.bfloat16 in dts
                and k != "sqnorm_blocks"]     # test_torch_f16_cuda.py's


def plane_operand(dev, gen, W, R, dtype, scale=1.0):
    x = torch.randn((W, R, 128), device=dev, generator=gen) * scale
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("W,R", [(1, 8), (3, 264), (2, 2048)])
@pytest.mark.parametrize("kernel,dts", PLANE_COMBOS,
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(str(d).split(".")[-1] for d in v))
def test_cuda_plane_kernel_bf16_instantiations(cuda_device, kernel, dts, W,
                                               R):
    gen = torch.Generator(device=cuda_device).manual_seed(W * R)
    a = plane_operand(cuda_device, gen, W, R, dts[0])
    b = plane_operand(cuda_device, gen, W, R, dts[1], 0.5)
    e = plane_operand(cuda_device, gen, W, R, torch.float32, 0.01)
    fp_kernels.reset_launches()
    if kernel == "delta_sqnorm_blocks":
        for bb in (b, b[0]):                  # stacked and broadcast b
            got = fp_kernels.delta_sqnorm_blocks(a, bb)
            assert torch.equal(got, fp_kernels.delta_sqnorm_blocks(
                a.float(), bb.float()))
            # a sum: another order than the plain version's (as the
            # float32 kernel's, and the float16 file's contract)
            torch.testing.assert_close(got.cpu(), fp_ref.delta_sqnorm_blocks(
                a.cpu(), bb.cpu()), rtol=SUM_RTOL, atol=0)
    elif kernel == "absmax_blocks":
        got = fp_kernels.absmax_blocks(a, b, e)
        assert torch.equal(got, fp_kernels.absmax_blocks(a.float(),
                                                         b.float(), e))
        assert torch.equal(got.cpu(), fp_ref.absmax_blocks(
            a.cpu(), b.cpu(), e.cpu()))
    elif kernel == "laq_encode_blocks":
        steps = fp_kernels.absmax_blocks(a, b, e) / torch.full(
            (W, R // 8), 7.0, device=cuda_device)
        got = fp_kernels.laq_encode_blocks(a, b, e, steps, 4)
        want = fp_ref.laq_encode_blocks(a.cpu(), b.cpu(), e.cpu(),
                                        steps.cpu(), 4)
        wide = fp_kernels.laq_encode_blocks(a.float(), b.float(), e, steps, 4)
        for x, y, z in zip(got, want, wide):
            assert x.dtype == torch.float32 and torch.equal(x, z)
        # payload and residual bitwise the plain version, ‖p‖² a sum
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        torch.testing.assert_close(got[2].cpu(), want[2], rtol=SUM_RTOL,
                                   atol=0)
    else:
        mask = torch.tensor([True, False, True][:W], device=cuda_device)
        for mode in fp_kernels.MASK_MODES:
            for aa in (a, a[0]):
                got = fp_kernels.masked_combine(aa, b, mask, mode)
                assert got.dtype == b.dtype
                assert torch.equal(got.cpu(), fp_ref.masked_combine(
                    aa.cpu(), b.cpu(), mask.cpu(), mode))
                # the float32 fold on the widened operands, rounded once
                assert torch.equal(got, fp_kernels.masked_combine(
                    aa.float(), b.float(), mask, mode).to(b.dtype))
        out = b.clone()
        assert fp_kernels.masked_combine(a, out, mask, "add",
                                         out=out).data_ptr() \
            == out.data_ptr()
    assert fp_kernels.LAUNCHES[kernel + fp_kernels.SUFFIX[dts]] > 0
