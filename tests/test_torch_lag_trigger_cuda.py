"""The legacy per-leaf kernels' instantiations on the card, held to their
plain versions and to the float32 kernel.

Every test here needs a CUDA device (``cuda`` marker; they skip without
one).  The file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lag_trigger_cuda.py

Each instantiation of ``lag_trigger.ENTRIES`` (float32, (bf16, bf16),
(f32, bf16), LAQ's residual float32) at ragged sizes, with every operand's
base aligned for the kernels' 4-element vector loads and one element off
(the scalar path).  Tolerances: the masked update, the absmax and the LAQ
payload and residual bitwise the plain version; the sums within rtol 1e-5
of it (another summation order); and every output, sums included, bitwise
the float32 kernel on the operands widened to float32 at the same
alignment, because each instantiation loads at its own dtype, widens
exactly and then runs the float32 kernel's element-to-thread map and fold
order.  Any combination the table does not build raises ``TypeError``.
"""
import numpy as np
import pytest
import torch

from cuda_helpers import cuda_device  # noqa: F401 (a fixture)
from repro_torch.kernels.lag_trigger import lag_trigger as lt
from repro_torch.kernels.lag_trigger import lag_trigger, ops, ref

SUM_RTOL = 1e-5
SIZES = (1, 3, 127, 129, 1000, 257 * 33, 32768, 32769)
F32, BF16 = torch.float32, torch.bfloat16
PAIRS = [(BF16, BF16), (F32, BF16)]
DTYPES = ["float32", "bfloat16"]


def card(x: torch.Tensor, dtype, offset: int, device) -> torch.Tensor:
    """``x`` at ``dtype`` on the card, its base ``offset`` elements into
    its storage (1: unaligned, the scalar path)."""
    buf = torch.zeros((x.numel() + offset,), dtype=dtype, device=device)
    buf[offset:].copy_(x)
    return buf[offset:]


def operands(n, dtypes, offset, device, scales=(1.0, 0.5, 0.01)):
    gen = torch.Generator().manual_seed(n)
    xs = [torch.randn(n, generator=gen) * sc for sc in scales]
    return ([card(x, dt, offset, device) for x, dt in zip(xs, dtypes)],
            [card(x.to(dt), F32, offset, device) for x, dt in zip(xs, dtypes)])


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS, ids=["bb", "fb"])
def test_cuda_sums_and_update_at_bf16_operands(cuda_device, pair):
    for n in SIZES:
        for offset in (0, 1):
            (a, b), (wa, wb) = operands(n, pair, offset, cuda_device,
                                        (1.0, 0.5))
            got = lt.delta_sqnorm_2d(a, b)
            torch.testing.assert_close(got, ref.delta_sqnorm(a, b),
                                       rtol=SUM_RTOL, atol=0)
            assert torch.equal(got, lt.delta_sqnorm_2d(wa, wb))
            if pair[0] == BF16:
                got = lt.sqnorm_2d(a)
                torch.testing.assert_close(got, ref.sqnorm(a), rtol=SUM_RTOL,
                                           atol=0)
                assert torch.equal(got, lt.sqnorm_2d(wa))
            for m in (0.0, 1.0, 0.5):
                mt = torch.tensor(m, device=cuda_device)
                got = lt.masked_update_2d(a, b, mt)
                assert got.dtype == b.dtype
                assert torch.equal(got, ref.masked_lazy_update(a, b, mt))
                assert torch.equal(got, lt.masked_update_2d(wa, wb, mt)
                                   .to(b.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS, ids=["bb", "fb"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_laq_at_bf16_operands(cuda_device, pair, bits):
    for n in SIZES:
        for offset in (0, 1):
            (g, q, e), (wg, wq, we) = operands(n, pair + (F32,), offset,
                                               cuda_device)
            scale = lt.innovation_absmax_2d(g, q, e)
            assert torch.equal(scale, ref.innovation_absmax(g, q, e))
            assert torch.equal(scale, lt.innovation_absmax_2d(wg, wq, we))
            p, r, sq = lt.laq_encode_2d(g, q, e, scale, bits)
            assert p.dtype == r.dtype == F32
            wp, wr, wsq = ref.laq_encode(g, q, e, scale, bits)
            assert torch.equal(p, wp) and torch.equal(r, wr)
            torch.testing.assert_close(sq, wsq, rtol=SUM_RTOL, atol=0)
            xp, xr, xsq = lt.laq_encode_2d(wg, wq, we, scale, bits)
            assert torch.equal(p, xp) and torch.equal(r, xr)
            assert torch.equal(sq, xsq)


@pytest.mark.cuda
def test_cuda_instantiations_are_counted_apart(cuda_device):
    (a, b), _ = operands(1000, (F32, BF16), 0, cuda_device, (1.0, 0.5))
    (g, q, e), _ = operands(1000, (BF16, BF16, F32), 0, cuda_device)
    lt.reset_launches()
    lt.delta_sqnorm_2d(a, b)
    lt.masked_update_2d(a, b, torch.ones((), device=cuda_device))
    lt.sqnorm_2d(g)
    s = lt.innovation_absmax_2d(g, q, e)
    lt.laq_encode_2d(g, q, e, s, 4)
    assert {k: v for k, v in lt.LAUNCHES.items() if v} == {
        "delta_sqnorm_2d_fb": 1, "masked_update_2d_fb": 1,
        "sqnorm_2d_bf16": 1, "innovation_absmax_2d_bb": 1,
        "laq_encode_2d_bb": 1}


@pytest.mark.cuda
def test_cuda_unbuilt_combinations_raise(cuda_device):
    (a, b), _ = operands(64, (BF16, F32), 0, cuda_device, (1.0, 0.5))
    e = torch.zeros(64, dtype=BF16, device=cuda_device)
    with pytest.raises(TypeError, match="no instantiation"):
        lt.delta_sqnorm_2d(a, b)                   # (bf16, f32)
    with pytest.raises(TypeError, match="no instantiation"):
        lt.masked_update_2d(a, b, torch.ones((), device=cuda_device))
    with pytest.raises(TypeError, match="no instantiation"):
        lt.innovation_absmax_2d(a, a, e)           # a bfloat16 residual
    with pytest.raises(TypeError, match="no instantiation"):
        lt.laq_encode_2d(b, a, b.half(), torch.ones((), device=cuda_device),
                         4)


def operand(shape, seed, dtype="float32", scale=1.0):
    """Normal float32 values from a numpy seed as a tensor of ``dtype``
    (bfloat16 by round-to-nearest-even)."""
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    return torch.from_numpy(x).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

# ragged sizes: one element, under and over a vector group and a warp's
# worth, the reference's 257 × 33, a power of two and one past it
CUDA_SIZES = (1, 3, 127, 129, 1000, 257 * 33, 32768, 32769)


def card_operands(cuda_device, n, offset, specs, dtype="float32"):
    """Operands of n elements on the card; ``offset`` 1 views them one
    element into their storage, so the base is unaligned and the kernels
    take their scalar path."""
    return [operand((n + offset,), seed, dtype, scale).to(cuda_device)[
        offset:] for seed, scale in specs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_sums_and_update_match_plain(cuda_device, dtype):
    for n in CUDA_SIZES:
        for offset in (0, 1):
            a, b = card_operands(cuda_device, n, offset, ((0, 1.0),
                                                          (1, 1.0)), dtype)
            torch.testing.assert_close(lag_trigger.sqnorm_2d(a),
                                       ref.sqnorm(a), rtol=1e-5, atol=0)
            torch.testing.assert_close(lag_trigger.delta_sqnorm_2d(a, b),
                                       ref.delta_sqnorm(a, b), rtol=1e-5,
                                       atol=0)
            for m in (0.0, 1.0):
                got = lag_trigger.masked_update_2d(
                    a, b, torch.tensor(m, device=cuda_device))
                assert got.dtype == b.dtype
                assert torch.equal(got, ref.masked_lazy_update(a, b, m))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_laq_matches_plain_bitwise(cuda_device, bits):
    for n in CUDA_SIZES:
        for offset in (0, 1):
            g, q, e = card_operands(cuda_device, n, offset,
                                    ((10, 1.0), (11, 0.25), (12, 0.01)))
            scale = lag_trigger.innovation_absmax_2d(g, q, e)
            assert torch.equal(scale, ref.innovation_absmax(g, q, e))
            p, r, sq = lag_trigger.laq_encode_2d(g, q, e, scale, bits)
            wp, wr, wsq = ref.laq_encode(g, q, e, scale, bits)
            assert torch.equal(p, wp) and torch.equal(r, wr)
            torch.testing.assert_close(sq, wsq, rtol=1e-5, atol=0)
            steps = ops.laq_encode(g, q, e, bits=bits, return_steps=True)[3]
            assert torch.equal(steps, ref.quantizer_step(scale, bits)
                               .reshape(1))
