"""The port's model kernels against the LIVE JAX reference.

RMSNorm and flash attention: the port's dispatch (``ops``) on CPU tensors
runs the plain PyTorch version; it is held against the reference's Pallas
kernels in interpret mode (``repro.kernels.*.ops``) and against the
reference's oracles (``ref``), on the same numpy inputs, in float32.

Tolerances: RMSNorm 1e-5 absolute, the reference's own f32 tolerance for
its kernel against its oracle (``tests/test_kernels.py``); only the order
of the mean's sum differs.  Attention 1e-5 absolute on outputs of size
~1: the online softmax of the Pallas kernel rescales its partial sums per
kv block where the oracles take one softmax, and the dots run in another
order — f32 rounding of a few ulp per term, ~1e-6 measured.

The CUDA kernels themselves run only on the card: their ``cuda`` tests
are ``tests/test_torch_kernels_cuda.py``, and ``chip_smoke.py`` holds them
against the plain versions on an H100.  What the CPU can hold is the flash kernels'
arithmetic.  The float32 kernel runs both products on the tensor cores in
split TF32 (each operand x as hi = tf32(x) and lo = tf32(x − hi), a
product as lo·hi + hi·lo + hi·hi with float32 sums): a test-local
emulation of it is held to ``ATTN_TOL`` against the reference, and a
single TF32 pass is shown to miss it.  The bfloat16 kernel runs them on
the bfloat16 tensor cores (exact products, float32 sums of 16-column k
steps), with P split into three bfloat16 terms: its emulation is held
within one bfloat16 ulp (+ 1e-6) of the reference's kernel on the widened
inputs, rounded to bfloat16, and the library's arithmetic (P rounded to
one bfloat16 term) is shown to miss that.  Head_dims without an
instantiation are zero-padded to one, with their true scale: the padded
problem is held against the reference's kernel at its own head_dim 16 and
32 cases.  The card's own cases (each kernel against its plain version,
kernels 1–4 at bfloat16 operands) are ``tests/test_torch_kernels_cuda.py``,
which imports no JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as fa_ops
from repro.kernels.flash_attention import ref as fa_ref
from repro.kernels.rmsnorm import ops as rms_ops
from repro.kernels.rmsnorm import ref as rms_ref

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention as t_fa
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.kernels.rmsnorm import ops as t_rms_ops
from repro_torch.kernels.rmsnorm import ref as t_rms_ref
from repro_torch.kernels.rmsnorm import rmsnorm as t_rms

from rmsnorm_fold import RMS_WIDTHS, kernel_rmsnorm, kernel_rsqrt

RMS_TOL = 1e-5
ATTN_TOL = 1e-5


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def attn_inputs(S, Skv, B=2, H=4, KV=2, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    return q, k, v


def live_rows(S, Skv, window, *arrays):
    """Drop the rows that see no key (S > Skv under a window): the oracle's
    softmax over all −1e30 averages v, the Pallas kernel (and the CUDA one)
    floors l and writes 0."""
    if not (S > Skv and window is not None):
        return arrays
    live = np.arange(S) - window + 1 < Skv
    return tuple(np.asarray(a)[:, live] for a in arrays)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 256), (3, 7, 512), (1, 128)])
def test_rmsnorm_plain_matches_reference(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    before = t_rms.LAUNCHES["rmsnorm"]
    got = t_rms_ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    assert got.shape == shape and got.dtype == torch.float32
    pallas = rms_ops.rmsnorm(jnp.asarray(x), jnp.asarray(s))  # interpret
    oracle = rms_ref.rmsnorm(jnp.asarray(x), jnp.asarray(s))
    assert max_err(got, pallas) < RMS_TOL
    assert max_err(got, oracle) < RMS_TOL
    assert torch.equal(got, t_rms_ref.rmsnorm(torch.from_numpy(x),
                                              torch.from_numpy(s)))
    assert t_rms.LAUNCHES["rmsnorm"] == before      # no kernel on the CPU


def test_rmsnorm_eps_and_zero_rows():
    x = np.zeros((2, 128), np.float32)
    x[1] = 1e-4
    s = np.ones(128, np.float32)
    for eps in (1e-6, 1e-2):
        got = t_rms_ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s),
                                eps=eps)
        want = rms_ops.rmsnorm(jnp.asarray(x), jnp.asarray(s), eps=eps)
        assert max_err(got, want) < RMS_TOL
        assert float(got[0].abs().max()) == 0.0


# The CUDA kernel's fold order (tests/rmsnorm_fold.py) against the
# reference: the card holds the kernel to the same emulation bit for bit
# (tests/test_torch_rmsnorm_cuda.py).
def rms_case(d, dtype, rows=5):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    return x.to(dtype), s.to(dtype)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d", RMS_WIDTHS)
def test_kernel_fold_matches_reference(d, dtype):
    """The kernel's fold order against the reference's Pallas kernel in
    interpret mode and its oracle, on the same inputs: float32 within
    RMS_TOL; bfloat16 within one bfloat16 ulp a rounding, |scale|·ulp(y) +
    ulp(out) (a reordered mean may move y across a rounding boundary)."""
    x, s = rms_case(d, getattr(torch, dtype))
    got = kernel_rmsnorm(x, s, kernel_rsqrt(x)).float().numpy()
    jx = jnp.asarray(x.float().numpy()).astype(dtype)
    js = jnp.asarray(s.float().numpy()).astype(dtype)
    for want in (rms_ops.rmsnorm(jx, js), rms_ref.rmsnorm(jx, js)):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            assert max_err(got, want) < RMS_TOL
            continue
        y = torch.from_numpy(np.array(
            rms_ref.rmsnorm(jx.astype(jnp.float32), jnp.ones(d))))
        bound = (s.float().abs() * bf16_ulp(y) + bf16_ulp(torch.maximum(
            torch.from_numpy(got).abs(), torch.from_numpy(want).abs())))
        assert bool((torch.from_numpy(np.abs(got - want)) <= bound).all())


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

# S 63/64/65/129 and the last four cases sit on and around the CUDA
# kernel's 64-row and 64-key tile edges (window 100 crosses a tile)
ATTN_CASES = [(S, S, causal, window)
              for S in (40, 72, 63, 64, 65, 129)
              for causal, window in ((True, None), (True, 16),
                                     (False, None))] + [
    (40, 72, False, None), (40, 72, True, None), (72, 40, True, 16),
    (129, 129, True, 100), (65, 130, True, None), (130, 65, True, 100),
    (64, 129, False, 16)]


@pytest.mark.parametrize("S,Skv,causal,window", ATTN_CASES)
def test_attention_plain_matches_reference(S, Skv, causal, window):
    q, k, v = attn_inputs(S, Skv, seed=S * 7 + Skv)
    before = t_fa.LAUNCHES["flash_attention"]
    got = t_fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = fa_ops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window)            # interpret
    oracle = fa_ref.attention(jq, jk, jv, causal=causal, window=window)
    got, pallas, oracle = live_rows(S, Skv, window, got, pallas, oracle)
    assert max_err(got, pallas) < ATTN_TOL
    assert max_err(got, oracle) < ATTN_TOL
    assert t_fa.LAUNCHES["flash_attention"] == before


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic, emulated: split TF32 on the tensor cores
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, the 13 low mantissa bits dropped (on the int32 bits:
    the magnitude sits in the low 31, so adding half an ulp of TF32 and
    masking rounds either sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b as the kernel's mma.sync: TF32 operands, exact products (11 x
    11 significand bits), float32 sums; three products lo·hi + hi·lo +
    hi·hi, small terms first, or one (hi·hi)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def emulated_kernel(q, k, v, *, causal, window, passes=3):
    """The CUDA kernel's attention on numpy inputs: the scale folded into q
    at head_dim 64 and 256 (2^-3, 2^-4, exact) and applied to the scores
    after the product at 80 and 128 (no power of two), both products in
    split TF32 (at 256 the scores as float32 sums of 16-column partial
    products, as the kernel's pair of warps adds them), masked scores -1e30
    with weight 0, o = acc / max(l, 1e-30) (rows that see no key write
    0)."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    k, v = (torch.repeat_interleave(t, H // KV, dim=2) for t in (k, v))
    fold = hd in (64, 256)
    qs = (q * hd ** -0.5 if fold else q).permute(0, 2, 1, 3)
    kt = k.permute(0, 2, 3, 1)
    w = 16 if hd == 256 else hd              # columns of a partial product
    s = sum(split_mm(qs[..., c:c + w], kt[..., c:c + w, :], passes)
            for c in range(0, hd, w))                   # (B, H, S, Skv)
    if not fold:
        s = s * hd ** -0.5
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.tensor(-1e30))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.tensor(0.0))
    o = split_mm(p, v.permute(0, 2, 1, 3), passes)
    o = o / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return o.permute(0, 2, 1, 3).numpy()


def test_tf32_rounding_is_rna():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0 + 2 ** -12, 1.0 + 2 ** -23])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 3.0, 1.0])
    assert torch.equal(tf32(x), want)        # ties away from zero
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(
        1000).astype(np.float32))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert torch.equal(tf32(hi), hi)
    assert bool((((y - hi) / y).abs() <= 2.0 ** -11).all())
    # hi + lo holds y to 22 bits: what makes three products float32-exact
    assert bool((((hi.double() + lo.double() - y.double()) / y.double())
                 .abs() <= 2.0 ** -22).all())


@pytest.mark.parametrize("S,Skv,causal,window", ATTN_CASES)
def test_split_tf32_emulation_matches_reference(S, Skv, causal, window):
    q, k, v = attn_inputs(S, Skv, seed=S * 7 + Skv)
    got = emulated_kernel(q, k, v, causal=causal, window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = fa_ops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window)            # interpret
    oracle = fa_ref.attention(jq, jk, jv, causal=causal, window=window)
    got, pallas, oracle = live_rows(S, Skv, window, got, pallas, oracle)
    assert max_err(got, pallas) < ATTN_TOL
    assert max_err(got, oracle) < ATTN_TOL


def long_row_inputs():
    """One head, S = 2048, causal: the serving path's row length."""
    return attn_inputs(2048, 2048, B=1, H=1, KV=1, seed=2048)


def test_split_tf32_emulation_matches_reference_at_2048():
    q, k, v = long_row_inputs()
    got = emulated_kernel(q, k, v, causal=True, window=None)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    assert max_err(got, fa_ops.flash_attention(jq, jk, jv)) < ATTN_TOL
    assert max_err(got, fa_ref.attention(jq, jk, jv)) < ATTN_TOL


@pytest.mark.parametrize("S,causal,window", [(2048, True, None),
                                             (129, True, 100),
                                             (72, False, None)])
def test_single_tf32_pass_misses_the_tolerance(S, causal, window):
    """Why the kernel takes three products: one TF32 pass (10 mantissa
    bits per operand) misses ``ATTN_TOL`` by orders of magnitude on the
    same inputs on which the split passes."""
    q, k, v = (long_row_inputs() if S == 2048
               else attn_inputs(S, S, seed=S * 8))
    want = fa_ref.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                            window=window)
    split = emulated_kernel(q, k, v, causal=causal, window=window)
    single = emulated_kernel(q, k, v, causal=causal, window=window,
                             passes=1)
    assert max_err(split, want) < ATTN_TOL
    assert max_err(single, want) > 10 * ATTN_TOL


# ---------------------------------------------------------------------------
# The bfloat16 kernel's arithmetic, emulated: wgmma on bfloat16 operands
# ---------------------------------------------------------------------------

def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16 (to nearest even), kept as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_inputs(q, k, v):
    """numpy float32 inputs rounded to bfloat16 values (still float32: the
    widened inputs both kernels see)."""
    return tuple(bf16_round(torch.from_numpy(a)).numpy() for a in (q, k, v))


def top8(x: torch.Tensor) -> torch.Tensor:
    """The top 8 significant bits of float32 x, truncated: a bfloat16
    value (the kernel keeps the high 16 bits of the float)."""
    return (x.contiguous().view(torch.int32) & -0x10000).view(torch.float32)


def p_terms(p: torch.Tensor, terms: int = 3):
    """P as the kernel splits it, largest term first: each term the top 8
    bits of what the terms before it leave; three hold float32's 24 bits,
    so they sum to p exactly."""
    out = []
    for _ in range(terms):
        out.append(top8(p))
        p = p - out[-1]
    return out


def k16_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 16-column k steps of a @ b as wgmma runs them on bfloat16
    operands: each step's products exact (16 significant bits) and summed
    in float64, rounded once to float32 → (K/16, ..., M, N); the caller adds
    the steps in float32, in k order."""
    K = a.shape[-1]
    a4 = a.reshape(*a.shape[:-1], K // 16, 16).double()
    b4 = b.reshape(*b.shape[:-2], K // 16, 16, b.shape[-1]).double()
    return torch.einsum("...mkc,...kcn->...kmn", a4, b4).movedim(-3, 0) \
        .float()


def float32_sum(parts):
    """Parts added in float32, in order."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def emulated_bf16_kernel(q, k, v, *, causal, window, scale=None, terms=3,
                         rounded=False):
    """The bfloat16 kernel's attention on numpy inputs that hold bfloat16
    values: scores in one bfloat16 product (the scale folded into q where
    it is a power of two, exact; applied to the scores after the product
    elsewhere), masked scores -1e30 with weight 0, P split into ``terms``
    bfloat16 terms (``rounded``: P rounded to one bfloat16 term, the
    library's arithmetic), each 16 keys' products of the terms added
    smallest first into one float32 accumulator, o = acc / max(l, 1e-30)
    rounded to bfloat16 once.  ``scale`` defaults to head_dim ** -0.5 (a
    zero-padded head_dim keeps its true one)."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    k, v = (torch.repeat_interleave(t, H // KV, dim=2) for t in (k, v))
    scale = torch.tensor(hd ** -0.5 if scale is None else scale,
                         dtype=torch.float32)
    mant, _ = torch.frexp(scale)
    fold = bool(mant == 0.5)                  # a power of two
    qs = (q * scale if fold else q).permute(0, 2, 1, 3)
    s = float32_sum(list(k16_products(qs, k.permute(0, 2, 3, 1))))
    if not fold:
        s = s * scale
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.tensor(-1e30))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.tensor(0.0))
    pad = -Skv % 16                            # keys past Skv: p 0, v 0
    ps = [bf16_round(p)] if rounded else p_terms(p, terms)
    ps = [torch.nn.functional.pad(t, (0, pad)) for t in ps]
    vh = torch.nn.functional.pad(v.permute(0, 2, 1, 3), (0, 0, 0, pad))
    steps = [k16_products(t, vh) for t in reversed(ps)]   # smallest first
    o = float32_sum([st[kk] for kk in range(steps[0].shape[0])
                     for st in steps])
    o = o / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return bf16_round(o).permute(0, 2, 1, 3).numpy()


def within_one_bf16_ulp(got, want) -> bool:
    """|got − want| ≤ one bfloat16 ulp of the larger + 1e-6, everywhere:
    the contract of the bfloat16 kernel against the reference's kernel on
    the widened inputs, rounded to bfloat16."""
    got, want = torch.from_numpy(np.asarray(got, np.float32)), \
        torch.from_numpy(np.asarray(want, np.float32))
    bound = bf16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-6
    return bool(((got - want).abs() <= bound).all())


def pallas_bf16(q, k, v, *, causal, window):
    """The reference's Pallas kernel (interpret mode) on the widened
    inputs, rounded to bfloat16."""
    out = fa_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                 causal=causal, window=window)
    return bf16_round(torch.from_numpy(np.array(out))).numpy()


def test_bf16_split_is_exact():
    """Three truncated bfloat16 terms sum to float32 p exactly (24 = 3 x 8
    bits), each term a bfloat16 value; two leave up to 2^-15 of p."""
    p = torch.from_numpy(np.random.default_rng(5).random(4096)
                         .astype(np.float32))
    p = torch.cat([p, p * 1e-20, torch.tensor([0.0, 1.0, 2 ** -126])])
    hi, mid, lo = p_terms(p)
    for t in (hi, mid, lo):
        assert torch.equal(bf16_round(t), t)
    assert torch.equal((hi.double() + mid.double() + lo.double()).float(),
                       p)
    assert torch.equal(hi + mid + lo, p)
    two = p - (p_terms(p, 2)[0] + p_terms(p, 2)[1])
    assert float((two / p.clamp(min=1e-38)).max()) < 2.0 ** -15
    assert float(two.abs().max()) > 0.0


@pytest.mark.parametrize("S,Skv,causal,window", ATTN_CASES)
def test_bf16_emulation_within_one_ulp_of_reference(S, Skv, causal, window):
    q, k, v = bf16_inputs(*attn_inputs(S, Skv, seed=S * 11 + Skv))
    got = emulated_bf16_kernel(q, k, v, causal=causal, window=window)
    want = pallas_bf16(q, k, v, causal=causal, window=window)
    got, want = live_rows(S, Skv, window, got, want)
    assert within_one_bf16_ulp(got, want)


def test_bf16_emulation_within_one_ulp_of_reference_at_2048():
    q, k, v = bf16_inputs(*long_row_inputs())
    got = emulated_bf16_kernel(q, k, v, causal=True, window=None)
    assert within_one_bf16_ulp(got, pallas_bf16(q, k, v, causal=True,
                                                window=None))


@pytest.mark.parametrize("hd", (80, 128, 256))
@pytest.mark.parametrize("S,Skv,causal,window", [
    (129, 129, True, None), (72, 40, True, 16), (65, 130, False, None)])
def test_bf16_emulation_within_one_ulp_of_reference_wide_heads(
        S, Skv, causal, window, hd):
    """80^-0.5 and 128^-0.5 are no powers of two: the scores are scaled
    after the product; 256^-0.5 = 1/16 folds into q."""
    q, k, v = bf16_inputs(*attn_inputs(S, Skv, hd=hd, seed=S + Skv + hd))
    got = emulated_bf16_kernel(q, k, v, causal=causal, window=window)
    want = pallas_bf16(q, k, v, causal=causal, window=window)
    got, want = live_rows(S, Skv, window, got, want)
    assert within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("S,causal,window", [(2048, True, None),
                                             (129, True, 100),
                                             (72, False, None)])
def test_one_bf16_term_of_p_misses_the_tolerance(S, causal, window):
    """Why P is split: the library's arithmetic, P rounded to one bfloat16
    term (8 bits) before P·V, misses the one-ulp contract on the same
    inputs on which the three-term split holds it."""
    q, k, v = bf16_inputs(*(long_row_inputs() if S == 2048
                            else attn_inputs(S, S, seed=S * 13)))
    want = pallas_bf16(q, k, v, causal=causal, window=window)
    split = emulated_bf16_kernel(q, k, v, causal=causal, window=window)
    single = emulated_bf16_kernel(q, k, v, causal=causal, window=window,
                                  rounded=True)
    assert within_one_bf16_ulp(split, want)
    assert not within_one_bf16_ulp(single, want)


@pytest.mark.parametrize("S,causal,window", [(2048, True, None),
                                             (129, True, 100),
                                             (72, False, None)])
def test_two_bf16_terms_of_p_miss_the_tolerance(S, causal, window):
    """Why three terms: two (16 of p's 24 bits) leave up to 2^-15 of each
    weight, which moves outputs near 0 past one bfloat16 ulp + 1e-6."""
    q, k, v = bf16_inputs(*(long_row_inputs() if S == 2048
                            else attn_inputs(S, S, seed=S * 13)))
    want = pallas_bf16(q, k, v, causal=causal, window=window)
    two = emulated_bf16_kernel(q, k, v, causal=causal, window=window,
                               terms=2)
    assert not within_one_bf16_ulp(two, want)


# ---------------------------------------------------------------------------
# Any head_dim from 1 to 256: zero-padded to a built one, true scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,built", [(1, 64), (16, 64), (32, 64), (64, 64),
                                      (65, 80), (80, 80), (96, 128),
                                      (129, 256), (256, 256)])
def test_pad_head_dim_to_the_next_built_one(hd, built):
    q, k, v = map(torch.from_numpy, attn_inputs(5, 7, B=1, hd=hd))
    assert t_fa.padded_head_dim(hd) == built
    qp, kp, vp = t_fa.pad_head_dim(q, k, v)
    for a, ap in ((q, qp), (k, kp), (v, vp)):
        assert ap.shape == a.shape[:-1] + (built,)
        assert torch.equal(ap[..., :hd], a)
        assert not ap[..., hd:].any()
    if hd == built:
        assert qp is q and kp is k and vp is v


@pytest.mark.parametrize("hd", [0, 257, 512])
def test_pad_head_dim_refuses_what_no_instantiation_covers(hd):
    with pytest.raises(ValueError, match=f"head_dim {hd} not served"):
        t_fa.padded_head_dim(hd)


# tests/test_kernels.py's flash cases at head_dim 32 and 16 (B, S, H, KV,
# hd, causal, window)
REF_SMALL_HEADS = [(2, 128, 4, 2, 32, True, None), (2, 128, 4, 4, 32, True, 32),
                   (1, 96, 2, 2, 16, False, None)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", REF_SMALL_HEADS)
def test_zero_padded_head_dim_is_the_reference_function(B, S, H, KV, hd,
                                                        causal, window):
    """What the kernels run at a head_dim below 64: the plain attention on
    operands zero-padded to 64 with the true scale hd^-0.5, cut back to hd
    columns, against the reference's Pallas kernel (interpret mode) on the
    operands; and the bfloat16 kernel's arithmetic on the padded bfloat16
    operands (32^-0.5 is no power of two: no fold at 64) within one
    bfloat16 ulp of it."""
    q, k, v = attn_inputs(S, S, B=B, H=H, KV=KV, hd=hd, seed=hd * 7 + S)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = fa_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    bq=64, bk=64)             # interpret
    padded = t_fa.pad_head_dim(*map(torch.from_numpy, (q, k, v)))
    assert padded[0].shape[-1] == 64
    got = t_fa_ref.attention(*padded, causal=causal, window=window,
                             scale=hd ** -0.5)
    assert torch.equal(got[..., hd:], torch.zeros_like(got[..., hd:]))
    assert max_err(got[..., :hd], pallas) < ATTN_TOL
    qb, kb, vb = bf16_inputs(q, k, v)
    emulated = emulated_bf16_kernel(
        *(t.numpy() for t in t_fa.pad_head_dim(
            *map(torch.from_numpy, (qb, kb, vb)))),
        causal=causal, window=window, scale=hd ** -0.5)
    assert within_one_bf16_ulp(emulated[..., :hd],
                               pallas_bf16(qb, kb, vb, causal=causal,
                                           window=window))


# head_dims 80 (hubert-xlarge), 128 (llama3.2-3b, granite-8b,
# command-r-35b, qwen2-vl-7b) and 256 (recurrentgemma-9b): the kernel's
# other three instantiations
WIDE_HEADS = (80, 128, 256)


@pytest.mark.parametrize("hd", WIDE_HEADS)
@pytest.mark.parametrize("S,Skv,causal,window", ATTN_CASES)
def test_attention_plain_matches_reference_wide_heads(S, Skv, causal,
                                                      window, hd):
    q, k, v = attn_inputs(S, Skv, hd=hd, seed=S * 5 + Skv + hd)
    got = t_fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    oracle = fa_ref.attention(jq, jk, jv, causal=causal, window=window)
    got, oracle = live_rows(S, Skv, window, got, oracle)
    assert max_err(got, oracle) < ATTN_TOL


@pytest.mark.parametrize("hd", WIDE_HEADS)
@pytest.mark.parametrize("S,Skv,causal,window", [
    (129, 129, True, None), (72, 40, True, 16), (65, 130, False, None),
    (130, 65, True, 100)])
def test_split_tf32_emulation_matches_reference_wide_heads(S, Skv, causal,
                                                           window, hd):
    """At head_dims whose scale is no power of two the kernel scales the
    scores after the product; the emulation does the same."""
    q, k, v = attn_inputs(S, Skv, hd=hd, seed=S * 3 + Skv + hd)
    got = emulated_kernel(q, k, v, causal=causal, window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = fa_ops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window)            # interpret
    oracle = fa_ref.attention(jq, jk, jv, causal=causal, window=window)
    got, pallas, oracle = live_rows(S, Skv, window, got, pallas, oracle)
    assert max_err(got, pallas) < ATTN_TOL
    assert max_err(got, oracle) < ATTN_TOL


# recurrentgemma's lattn: one KV head, its sliding window (2048 at full
# size) straddling tiles, the reference's Pallas kernel in interpret mode
HD256_KV1_CASES = [(72, 72, True, 16), (129, 129, True, 64),
                   (130, 65, True, 100), (65, 130, True, 40)]


@pytest.mark.parametrize("S,Skv,causal,window", HD256_KV1_CASES)
def test_attention_plain_matches_pallas_at_head_dim_256_one_kv_head(
        S, Skv, causal, window):
    q, k, v = attn_inputs(S, Skv, H=4, KV=1, hd=256, seed=S + Skv)
    got = t_fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = fa_ops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window)            # interpret
    emulated = emulated_kernel(q, k, v, causal=causal, window=window)
    got, pallas, emulated = live_rows(S, Skv, window, got, pallas, emulated)
    assert max_err(got, pallas) < ATTN_TOL
    assert max_err(emulated, pallas) < ATTN_TOL


def test_kernel_instantiations_and_their_shared_memory():
    """One instantiation per built head_dim in each dtype, each within
    Hopper's 227 KB a block.  float32: eight warps an SM, two blocks of
    four warps at 64, 80 and 128, one block of eight (two warps per 16
    query rows, 224 KB) at 256.  bfloat16: one block an SM of two consumer
    warpgroups (64 query rows each) and a producer warpgroup, every
    head_dim stored unpadded in 64-column chunks (80: 64 + 16), tiles of
    16-key multiples."""
    assert t_fa.HEAD_DIMS == (64, 80, 128, 256)
    assert t_fa.SHARED_BYTES[64] == 114688     # head_dim 64's layout, unchanged
    assert t_fa.SHARED_BYTES[256] == 229376
    for hd, (hdp, bk, _, halves) in t_fa.INSTANCES.items():
        assert (hdp // halves) % 32 == 0 and hd <= hdp and bk % 8 == 0
        assert t_fa.SHARED_BYTES[hd] <= 232448
        blocks = 232448 // t_fa.SHARED_BYTES[hd]
        assert blocks * 4 * halves == 8, hd
    assert tuple(t_fa.INSTANCES_BF16) == t_fa.HEAD_DIMS
    assert t_fa.SHARED_BYTES_BF16 == {64: 83008, 80: 103488, 128: 99392,
                                      256: 197696}
    for hd, (bk, wgs) in t_fa.INSTANCES_BF16.items():
        assert wgs == 2 and bk % 16 == 0 and bk <= 128
        assert hd % 64 in (0, 16)              # 64-column chunks + a tail
        assert t_fa.SHARED_BYTES_BF16[hd] <= 232448


def test_attention_gqa_reads_kv_head_h_over_q_per_kv():
    """Query head h attends with kv head h // (H/KV): zeroing kv head 1
    changes exactly the outputs of query heads 2 and 3."""
    q, k, v = map(torch.from_numpy, attn_inputs(16, 16, B=1))
    out = t_fa_ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 1] = 0.0
    v2[:, :, 1] = 0.0
    out2 = t_fa_ops.flash_attention(q, k2, v2)
    assert torch.equal(out[:, :, :2], out2[:, :, :2])
    assert not torch.equal(out[:, :, 2:], out2[:, :, 2:])


def test_plain_attention_is_differentiable():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in attn_inputs(24, 24, B=1))
    t_fa_ops.flash_attention(q, k, v, causal=True, window=8).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


# ---------------------------------------------------------------------------
# The CUDA wrappers take CUDA tensors only; the builder
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    """No silent fallback inside the kernel wrappers: a CPU tensor is the
    dispatcher's business, the wrapper raises."""
    x = torch.ones((8, 128))
    with pytest.raises(ValueError, match="CUDA"):
        t_rms.rmsnorm_2d(x, torch.ones(128))
    with pytest.raises(ValueError, match="CUDA"):
        t_rms_ops.rmsnorm_2d(x, torch.ones(128))
    q, k, v = map(torch.from_numpy, attn_inputs(8, 8, B=1))
    with pytest.raises(ValueError, match="CUDA"):
        t_fa.flash_attention_fwd(q, k, v)


def test_builder_caches_by_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    lib = build.CudaLibrary("demo", src, {"f": ()})
    other = build.CudaLibrary("demo", src, {"f": ()}, extra_flags=("-G",))
    assert lib.path() != other.path()
    assert lib.path().name.startswith("libdemo_")
    first = lib.path()
    src.write_text("// b\n")
    assert lib.path() != first                 # an edited source rebuilds

    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "out")
    (tmp_path / "out").mkdir()
    lib.path().write_bytes(b"")                # already built: no nvcc

    def no_nvcc():
        raise AssertionError("nvcc must not run for a cached library")
    monkeypatch.setattr(build, "nvcc", no_nvcc)
    build.build([lib])
    with pytest.raises(AssertionError):
        build.build([other])


def test_kernel_libraries_share_one_builder():
    from repro_torch.fastpath import kernels as fp
    from repro_torch.kernels.lag_trigger import lag_trigger as lt
    libs = [fp.LIBRARY, t_rms.LIBRARY, t_fa.LIBRARY, t_fa.LIBRARY_BF16,
            lt.LIBRARY]
    assert len({lib.name for lib in libs}) == 5
    assert {lib.path().parent for lib in libs} == {build.build_dir()}
    assert build.build_dir().parts[-2:] == ("build", "torch_ext")
    assert all(lib.source.exists() and "sm_90a" in " ".join(lib.flags)
               for lib in libs)
    assert "--fmad=false" in fp.LIBRARY.flags
    assert "--fmad=false" in lt.LIBRARY.flags


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
