"""float16 kernels and serving: the port's float16 paths against the LIVE
JAX reference on the CPU (the kernels' plain versions; the Pallas kernels in
interpret mode).

- Kernels 1-5 (the comm plane) and 8-12 (the legacy per-leaf route) at
  float16 operands, (f16, f16) and (f32, f16), on inputs that reach
  float16's subnormals (below 2^-14, down to 2^-24) and ±65504 (sums that
  overflow to ±inf on the write): the plain versions against the
  reference's Pallas kernels, masked folds, maxima and payloads bitwise,
  sums within the float32 sum-order tolerance, residuals within the
  reference's own LAQ tolerance (``test_torch_layout_plan``); each plain
  version bitwise the float32 plain version on the widened operands.
- Kernel 6's rows kernel (what the TMA stream does not take): its fold
  (the stream's, by d alone), emulated in ``rmsnorm_fold.rows_mean_square``,
  against the reference's kernel at d 1 to 20000 in all three dtypes:
  float32 within 1e-5, a 2-byte dtype within one ulp a rounding.
- Kernel 7 at float16: the kernel's arithmetic emulated (one float16
  product for the scores, P split into two float16 terms scaled by 2^14
  and 2^26, two phases into one float32 accumulator) within one float16
  ulp (+ 1e-6) of the reference's kernel on the widened inputs, rounded,
  on ragged cases and on the dominant-key rows (one key ahead by 18: the
  other weights, about 1.5e-8, lie below float16's 2^-24).  One scaled
  term misses that contract on the ragged cases, and the unscaled split
  (bfloat16's design at float16: two or three terms) misses it on the
  dominant-key rows.
- Kernel 7 above head_dim 256 (320): the port's route against the
  reference's kernel, float32 within 1e-5, float16 within one ulp.
- Serving a reduced float16 llama3.2-1b: prefill and decode logits within
  3× the reference's own float16 error against its float32 run (XLA-CPU
  keeps float16 intermediates in float32, ROADMAP queue 3), both routes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.fastpath import kernels as jk
from repro.fastpath.layout import FlatLayout as JFlatLayout
from repro.fastpath.plan import FastPathPlan as JPlan
from repro.kernels.flash_attention import ops as fa_ops
from repro.kernels.lag_trigger import lag_trigger as jkernels
from repro.kernels.lag_trigger import ops as jops
from repro.kernels.rmsnorm import ops as rms_ops
from repro.kernels.rmsnorm import ref as rms_ref
from repro.models import model as jmodel

from repro_torch.configs import get_config
from repro_torch.fastpath import kernels, kernels_ref
from repro_torch.kernels.flash_attention import flash_attention as t_fa
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.lag_trigger import ops, ref
from repro_torch.models import model
from repro_torch.weights import params_from_reference

from rmsnorm_fold import RMS_ROWS_WIDTHS, kernel_rmsnorm, rows_mean_square
from test_torch_kernels import (ATTN_TOL, RMS_TOL, attn_inputs, float32_sum,
                                k16_products, live_rows)
from test_torch_mixed_round import check_laq_leaf, j2d

F16 = dict(dtype="float16", param_dtype="float16")
SUM_RTOL = 1e-5
#: the LAQ residual's tolerance against XLA-CPU's fused encode, in ulps of
#: |v| (test_torch_layout_plan's)
RESID_ULPS = 2
#: the port's float16 error against the reference's float32 run, as a
#: multiple of the reference's own float16 error (test_torch_f16_train)
ERR_RATIO = 3.0


def f16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One float16 ulp at |x| (11 significant bits; 2^-24 below 2^-14)."""
    _, e = torch.frexp(x.double().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                       torch.clamp(e, min=-13) - 11)


def edged(shape, seed, scale=1.0) -> np.ndarray:
    """Normal float32 values with float16's edges: every 97th times 1e-5
    (its subnormals), every 101st 3e-8 (about 2^-24), every 103rd +65504
    and every 211th -65504 (its largest finite values)."""
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    v = x.reshape(-1)
    v[::97] *= np.float32(1e-5)
    v[5::101] = 3e-8
    v[7::103] = 65504.0
    v[11::211] = -65504.0
    return x


def bits_equal(a, b) -> bool:
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# Kernels 1-5: the comm plane at float16 operands
# ---------------------------------------------------------------------------

LEAVES = {"w": (1,), "a": (127,), "b": (129,), "blk": (33, 257)}
W = 3
COMBOS = {"hh": (np.float16, np.float16), "fh": (np.float32, np.float16)}


@functools.lru_cache(maxsize=None)
def plane_operands(combo):
    """(g, q, e) as the plane's (W, R, 128) buffers of one ragged layout:
    numpy at their dtypes (g and q at the combination's, e float32)."""
    lo = JFlatLayout.for_tree({k: np.zeros(s, np.float32)
                               for k, s in LEAVES.items()})
    bufs = []
    for i, (scale, dt) in enumerate(((1.0, COMBOS[combo][0]),
                                     (0.5, COMBOS[combo][1]),
                                     (0.01, np.float32))):
        tree = {k: edged((W,) + s, 10 * i + j, scale)
                for j, (k, s) in enumerate(LEAVES.items())}
        bufs.append(np.array(lo.flatten_stacked(tree)).astype(dt))
    return lo, bufs


def as_t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("combo", list(COMBOS))
def test_plane_sums_and_maxima_at_f16_match_pallas(combo):
    """delta_sqnorm_blocks within SUM_RTOL, absmax_blocks bitwise, each the
    float32 plain version on the widened operands bit for bit; and
    sqnorm_blocks at float16 and bfloat16 (kernel 5)."""
    _, (g, q, e) = plane_operands(combo)
    tg, tq, te = as_t(g, q, e)
    got = kernels.delta_sqnorm_blocks(tg, tq)
    assert torch.equal(got, kernels.delta_sqnorm_blocks(tg.float(),
                                                        tq.float()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jk.delta_sqnorm_blocks(
        jnp.asarray(g), jnp.asarray(q))), rtol=SUM_RTOL, atol=0)
    got = kernels.absmax_blocks(tg, tq, te)
    assert torch.equal(got, kernels.absmax_blocks(tg.float(), tq.float(), te))
    assert bits_equal(got.numpy(), jk.absmax_blocks(
        *map(jnp.asarray, (g, q, e))))
    for dt in (torch.float16, torch.bfloat16):
        a = tq.to(dt)
        got = kernels.sqnorm_blocks(a)
        assert torch.equal(got, kernels_ref.sqnorm_blocks(a.float()))
        ja = jnp.asarray(a.float().numpy()).astype(str(dt).split(".")[1])
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jk.sqnorm_blocks(ja)), rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("combo", list(COMBOS))
def test_plane_laq_encode_at_f16_matches_pallas(combo, bits):
    lo, (g, q, e) = plane_operands(combo)
    parts = np.asarray(jk.absmax_blocks(*map(jnp.asarray, (g, q, e))))
    steps = np.asarray(JPlan._per_leaf(jnp.asarray(parts), lo, "max")) \
        / np.float32(2 ** (bits - 1) - 1)
    steps_subs = np.ascontiguousarray(steps[:, lo.sub_leaf])
    steps_subs = np.where(np.isfinite(steps_subs), steps_subs,
                          0).astype(np.float32)
    jp, jr, jsq = jk.laq_encode_blocks(*map(jnp.asarray, (g, q, e)),
                                       jnp.asarray(steps_subs), bits)
    tg, tq, te, ts = as_t(g, q, e, steps_subs)
    p, r, sq = kernels.laq_encode_blocks(tg, tq, te, ts, bits)
    wide = kernels.laq_encode_blocks(tg.float(), tq.float(), te, ts, bits)
    for x, y in zip((p, r, sq), wide):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    assert bits_equal(p.numpy(), jp)                  # payload = codes·step
    v = (g.astype(np.float32) - q.astype(np.float32)) + e
    assert np.all(np.abs(r.numpy() - np.asarray(jr))
                  <= RESID_ULPS * np.spacing(np.abs(v)))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=SUM_RTOL)


@pytest.mark.parametrize("combo,mode", [
    ("hh", "add"), ("hh", "update"), ("hh", "select"), ("fh", "add"),
    ("fh", "update")])          # select copies within one dtype
def test_plane_masked_combine_at_f16_matches_pallas(combo, mode):
    """Written at float16 with one rounding: into its subnormals, and to
    ±inf where a sum passes 65504, bitwise the reference's kernel's float32
    result rounded once."""
    _, (a, b, _) = plane_operands(combo)
    mask = np.array([True, False, True])
    got = kernels.masked_combine(*as_t(a, b), torch.from_numpy(mask), mode)
    assert got.dtype == torch.float16
    ta, tb = as_t(a, b)
    assert torch.equal(got, kernels.masked_combine(
        ta.float(), tb.float(), torch.from_numpy(mask), mode).half())
    # the reference's kernel writes float32: the port's is it rounded once
    want = np.asarray(jk.masked_combine(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(mask), mode))
    assert want.dtype == np.float32
    with np.errstate(over="ignore"):          # 65504 + 65504 rounds to inf
        want = want.astype(np.float16)
    assert bits_equal(got.numpy(), want)
    if mode == "add":
        assert bool(torch.isinf(got).any())          # 65504 + 65504
        assert bool(((got != 0) & (got.abs() < 2 ** -14)).any())


# ---------------------------------------------------------------------------
# Kernels 8-12: the legacy per-leaf route at float16 operands
# ---------------------------------------------------------------------------

def leaf(shape, seed, dtype, scale=1.0):
    x = edged(shape, seed, scale)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("shape", [(1000,), (257, 33)])
@pytest.mark.parametrize("combo", [("float16", "float16"),
                                   ("float32", "float16")], ids=["hh", "fh"])
def test_legacy_plain_versions_match_pallas_at_f16(shape, combo):
    (ja, ta), (jb, tb) = leaf(shape, 0, combo[0]), leaf(shape, 1, combo[1],
                                                         0.5)
    np.testing.assert_allclose(
        float(ops.delta_sqnorm(ta, tb)),
        float(jkernels.delta_sqnorm_2d(*j2d(ja, jb))), rtol=SUM_RTOL)
    for mask in (0.0, 1.0):
        got = ops.masked_lazy_update(ta, tb, torch.tensor(mask))
        want = jops.masked_lazy_update(ja, jb, jnp.asarray(mask))
        assert got.dtype == torch.float16
        assert bits_equal(got.numpy(), want)
    (jg, tg), (jq, tq), (je, te) = leaf(shape, 10, combo[0]), \
        leaf(shape, 11, combo[1], 0.25), leaf(shape, 12, "float32", 0.01)
    assert bits_equal(ref.innovation_absmax(tg, tq, te).numpy(),
                      jkernels.innovation_absmax_2d(*j2d(jg, jq, je)))
    for bits in (2, 8):
        p, r, lhs, steps = ops.laq_encode(tg, tq, te, bits=bits,
                                          return_steps=True)
        jp, jr, jlhs, jsteps = jops.laq_encode(jg, jq, je, bits=bits,
                                               use_ref=False,
                                               return_steps=True)
        assert p.dtype == r.dtype == torch.float32
        check_laq_leaf((tg.float() - tq.float() + te).numpy(), p, r,
                       steps[0], jp, jr, jsteps[0],
                       ref.innovation_absmax(tg, tq, te), bits)
        np.testing.assert_allclose(float(lhs), float(jlhs), rtol=SUM_RTOL)
    if combo[0] == "float16":
        np.testing.assert_allclose(
            float(ops.fused_tree_sqnorm(ta)),
            float(jkernels.sqnorm_2d(*j2d(ja))), rtol=SUM_RTOL)


# ---------------------------------------------------------------------------
# Kernel 6's rows kernel: its fold against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("d", RMS_ROWS_WIDTHS)
def test_rows_kernel_fold_matches_reference(d, dtype):
    """The rows kernel's fold (the stream's order, by d alone: the same at
    element offsets 0 to 3 of a buffer) against the reference's Pallas
    kernel in interpret mode and its oracle: float32 within RMS_TOL; a
    2-byte dtype within one ulp a rounding, |scale|·ulp(y) + ulp(out)."""
    rng = np.random.default_rng(d)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32)
                         ).to(tdt)
    s = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(tdt)
    ms = rows_mean_square(x)
    for off in range(1, 4):
        buf = torch.zeros(x.numel() + off, dtype=tdt)
        xo = buf[off:].view(8, d).copy_(x)
        assert xo.storage_offset() == off
        assert ms.tobytes() == rows_mean_square(xo).tobytes()
    r = torch.from_numpy((1.0 / np.sqrt(ms.astype(
        np.float64))).astype(np.float32))[:, None]
    got = kernel_rmsnorm(x, s, r).float().numpy()
    jx = jnp.asarray(x.float().numpy()).astype(dtype)
    js = jnp.asarray(s.float().numpy()).astype(dtype)
    ulp = f16_ulp if dtype == "float16" else (
        lambda t: torch.ldexp(torch.ones_like(t, dtype=torch.float64),
                              torch.frexp(t.double().abs())[1] - 8))
    for want in (rms_ops.rmsnorm(jx, js), rms_ref.rmsnorm(jx, js)):
        want = np.array(want.astype(jnp.float32))
        if dtype == "float32":
            assert np.max(np.abs(got - want)) < RMS_TOL
            continue
        y = torch.from_numpy(np.array(
            rms_ref.rmsnorm(jx.astype(jnp.float32), jnp.ones(d))))
        bound = (s.double().abs() * ulp(y) + ulp(torch.maximum(
            torch.from_numpy(got).abs(), torch.from_numpy(want).abs())))
        assert bool((torch.from_numpy(np.abs(got - want)) <= bound).all())


# ---------------------------------------------------------------------------
# Kernel 7 at float16: the P split
# ---------------------------------------------------------------------------

def f16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(torch.float32)


def p_phases(p: torch.Tensor, terms: int, scaled: bool):
    """P as the float16 kernel splits it → (out_scale, into_acc, fresh):
    the terms multiplied into the running output, the terms multiplied into
    a fresh accumulator each tile with the factor it is folded back by (or
    None), and the output's factor at the end.  Scaled (the design): x =
    p·2^14, hi = f16(x) into the output, lo = f16((x − hi)·2^12) fresh,
    folded back times 2^-12; the output times 2^-14.  Unscaled (bfloat16's
    split at float16): each term f16 of what the terms before it leave,
    smallest first, all into the output."""
    if scaled:
        x = p * 2.0 ** 14
        hi = f16_round(x)
        if terms == 1:
            return 2.0 ** -14, [hi], None
        lo = f16_round((x - hi) * 2.0 ** 12)
        return 2.0 ** -14, [hi], (2.0 ** -12, [lo])
    out = []
    for _ in range(terms):
        out.append(f16_round(p))
        p = p - out[-1]
    return 1.0, out[::-1], None


def emulated_f16_kernel(q, k, v, *, causal, window, terms=2, scaled=True,
                        order="one_wait"):
    """The float16 kernel's attention on numpy inputs that hold float16
    values: scores in one product (exact terms, float32 sums of 16-column
    k steps), times the scale after it (never folded into q), masked
    scores -1e30 with weight 0, P split by ``p_phases`` (the weights taken
    against the row's max; the online rescale by alpha is left out), in
    tiles of the instantiation's keys.  ``one_wait`` (the kernel): each
    tile's 16-key products of the output's terms added in order into the
    running output, those of the fresh terms into a fresh float32
    accumulator, folded in times its factor (one rounding); o = acc ·
    out_scale / max(l, 1e-30) rounded to float16.  ``two_phase`` (the
    order before, which waited twice): each tile's fresh products times
    their factor, then the output's terms added to them, the tile times
    out_scale added to the output."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    k, v = (torch.repeat_interleave(t, H // KV, dim=2) for t in (k, v))
    s = float32_sum(list(k16_products(q.permute(0, 2, 1, 3),
                                      k.permute(0, 2, 3, 1))))
    s = s * torch.tensor(hd ** -0.5, dtype=torch.float32)
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
    pad = -Skv % 16
    vh = torch.nn.functional.pad(v.permute(0, 2, 1, 3), (0, 0, 0, pad))
    out_scale, into_acc, fresh = p_phases(p, terms, scaled)

    def steps(ts):
        return [k16_products(torch.nn.functional.pad(t, (0, pad)), vh)
                for t in ts]

    hi_steps = steps(into_acc)
    lo_steps = steps(fresh[1]) if fresh else []
    per_tile = t_fa.INSTANCES_F16[t_fa.padded_head_dim(hd)][0] // 16
    acc = torch.zeros(hi_steps[0].shape[1:])
    for t0 in range(0, hi_steps[0].shape[0], per_tile):
        kks = range(t0, min(t0 + per_tile, hi_steps[0].shape[0]))
        f = None
        for kk in kks:
            for st in lo_steps:
                f = st[kk] if f is None else f + st[kk]
        if order == "one_wait":
            for kk in kks:
                for st in hi_steps:
                    acc = acc + st[kk]
            if f is not None:
                acc = acc + f * fresh[0]
        else:
            tile = None if f is None else f * fresh[0]
            for kk in kks:
                for st in hi_steps:
                    tile = st[kk] if tile is None else tile + st[kk]
            acc = acc + tile * out_scale
    if order == "one_wait":
        acc = acc * out_scale
    o = acc / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return f16_round(o).permute(0, 2, 1, 3).numpy()


def within_one_f16_ulp(got, want) -> bool:
    got, want = torch.from_numpy(np.asarray(got, np.float32)), \
        torch.from_numpy(np.asarray(want, np.float32))
    bound = f16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-6
    return bool(((got - want).abs() <= bound).all())


def f16_inputs(q, k, v):
    return tuple(f16_round(torch.from_numpy(a)).numpy() for a in (q, k, v))


def pallas_f16(q, k, v, *, causal, window):
    out = fa_ops.flash_attention(*(jnp.asarray(a).astype(jnp.float16)
                                   for a in (q, k, v)),
                                 causal=causal, window=window)
    return np.asarray(out.astype(jnp.float32))


def dominant_key_inputs(S=2048, hd=64):
    """Every query sees key 0 ahead of the others by 18 (q·k·hd^-0.5 = 6 ·
    24 / 8); the other weights are about e^-18 = 1.5e-8, below float16's
    2^-24; v is 0 at key 0, so each output is theirs alone (about 1.5e-5 at
    the last row)."""
    rng = np.random.default_rng(7)
    q = np.zeros((1, S, 1, hd), np.float32)
    q[..., 0] = 6.0
    k = (0.01 * rng.standard_normal((1, S, 1, hd))).astype(np.float32)
    k[:, 0, :, 0] = 24.0
    v = rng.random((1, S, 1, hd)).astype(np.float32)
    v[:, 0] = 0.0
    return f16_inputs(q, k, v)


@functools.lru_cache(maxsize=None)
def dominant_case():
    q, k, v = dominant_key_inputs()
    return (q, k, v), pallas_f16(q, k, v, causal=True, window=None)


F16_ATTN_CASES = [(129, 129, True, None), (72, 72, True, 16),
                  (65, 65, False, None), (72, 40, True, 16)]


@pytest.mark.parametrize("S,Skv,causal,window", F16_ATTN_CASES)
def test_f16_split_within_one_ulp_and_one_term_misses(S, Skv, causal,
                                                      window):
    """The design (two scaled terms) within one float16 ulp (+ 1e-6) of the
    reference's kernel on the widened inputs, rounded; one scaled term (11
    of p's 24 bits) misses it."""
    q, k, v = f16_inputs(*attn_inputs(S, Skv, seed=S * 7 + Skv))
    want = pallas_f16(q, k, v, causal=causal, window=window)
    split = emulated_f16_kernel(q, k, v, causal=causal, window=window)
    one = emulated_f16_kernel(q, k, v, causal=causal, window=window,
                              terms=1)
    split, want_l, one = live_rows(S, Skv, window, split, want, one)
    assert within_one_f16_ulp(split, want_l)
    assert not within_one_f16_ulp(one, want_l)


def test_f16_split_on_the_dominant_key_rows():
    """The scaled split holds the one-ulp contract where every weight but
    one lies below 2^-24; the unscaled split, with two or three terms,
    flushes them and misses it (the outputs, about 1.5e-5, go to 0)."""
    (q, k, v), want = dominant_case()
    got = emulated_f16_kernel(q, k, v, causal=True, window=None)
    assert within_one_f16_ulp(got, want)
    assert float(np.abs(want).max()) > 1e-5
    for terms in (2, 3):
        flushed = emulated_f16_kernel(q, k, v, causal=True, window=None,
                                      terms=terms, scaled=False)
        assert not within_one_f16_ulp(flushed, want)


@pytest.mark.parametrize("case", [*F16_ATTN_CASES, "dominant"],
                         ids=lambda c: str(c))
def test_f16_one_wait_order_holds_the_two_phase_contract(case):
    """On the same P, the kernel's order (hi·V into the running output,
    lo·V fresh a tile and folded back times 2^-12: one wait) holds the
    contract the two-phase order (lo·V times 2^-12, then + hi·V, a tile at
    a time: two waits) held: both within one float16 ulp (+ 1e-6) of the
    reference's kernel on the widened inputs, rounded, and of each other."""
    if case == "dominant":
        (q, k, v), want = dominant_case()
        S = Skv = q.shape[1]
        causal, window = True, None
    else:
        S, Skv, causal, window = case
        q, k, v = f16_inputs(*attn_inputs(S, Skv, seed=S * 7 + Skv))
        want = pallas_f16(q, k, v, causal=causal, window=window)
    one = emulated_f16_kernel(q, k, v, causal=causal, window=window)
    two = emulated_f16_kernel(q, k, v, causal=causal, window=window,
                              order="two_phase")
    one, two, want = live_rows(S, Skv, window, one, two, want)
    assert within_one_f16_ulp(one, want)
    assert within_one_f16_ulp(two, want)
    assert within_one_f16_ulp(one, two)


def test_f16_instantiations_fit_registers_and_shared_memory():
    """One float16 instantiation per built head_dim: what a consumer
    thread keeps while P·V multiplies (floats: 64 rows x columns / 128
    threads each) is the running output, the fresh lo·V accumulator of a
    pass and P's two terms, and where the next tile's scores are issued
    before it, those too: within 208 of its 240 registers; the block
    within Hopper's 227 KB, and at least two ring stages (K of tile t + 1
    is read while V of tile t is)."""
    assert tuple(t_fa.INSTANCES_F16) == t_fa.HEAD_DIMS
    assert t_fa.SHARED_BYTES_F16 == {64: 115816, 80: 144488, 128: 132200,
                                     256: 197704}
    for hd, (bk, cols, stages, ahead) in t_fa.INSTANCES_F16.items():
        assert bk % 16 == 0 and bk <= 128 and hd % cols == 0
        live = hd // 2 + cols // 2 + bk // 2 + (bk // 2 if ahead else 0)
        assert live <= 208, hd
        assert stages >= 2 and t_fa.SHARED_BYTES_F16[hd] <= 232448


def test_f16_split_terms_are_float16_and_exact():
    """x = p·2^14 and both terms are float16 values (normal for p above
    2^-28); hi + lo·2^-12 holds x to 2^-23 of x there."""
    p = torch.from_numpy(np.random.default_rng(3).random(4096).astype(
        np.float32))
    p = torch.cat([p, p * 1e-8, torch.tensor([1.0, 2.0 ** -28, 0.0])])
    out_scale, (hi,), (fold, (lo,)) = p_phases(p, 2, True)
    assert (out_scale, fold) == (2.0 ** -14, 2.0 ** -12)
    for t in (lo, hi):
        assert torch.equal(f16_round(t), t)
        assert float(t.abs().max()) <= 65504.0
    x = p.double() * 2.0 ** 14
    err = (hi.double() + lo.double() * 2.0 ** -12 - x).abs()
    big = p >= 2.0 ** -28
    assert float((err[big] / x[big]).max()) <= 2.0 ** -23


# ---------------------------------------------------------------------------
# Kernel 7 above head_dim 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "float16"))
@pytest.mark.parametrize("S,Skv,causal,window", [(129, 129, True, None),
                                                 (72, 40, True, 16),
                                                 (40, 72, False, None)])
def test_head_dim_320_matches_reference(S, Skv, causal, window, dtype):
    """The wide kernel's function (float32 attention on the widened inputs,
    rounded once: the port's route on float32 inputs) against the
    reference's kernel: float32 within ATTN_TOL, float16 within one ulp
    (+ 1e-6); the port's float16 route keeps the dtype and shape."""
    q, k, v = attn_inputs(S, Skv, B=1, H=4, KV=2, hd=320, seed=S + Skv)
    if dtype == "float16":
        q, k, v = f16_inputs(q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    wide = t_fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    jq, jk_, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    want = fa_ops.flash_attention(jq, jk_, jv, causal=causal, window=window)
    got, want = live_rows(S, Skv, window, wide.numpy(),
                          np.asarray(want.astype(jnp.float32)))
    if dtype == "float32":
        assert np.max(np.abs(got - want)) < ATTN_TOL
        return
    assert within_one_f16_ulp(f16_round(torch.from_numpy(got)), want)
    route = t_fa_ops.flash_attention(*(t.half() for t in (tq, tk, tv)),
                                     causal=causal, window=window)
    assert route.dtype == torch.float16 and route.shape == tq.shape


# ---------------------------------------------------------------------------
# Serving a reduced float16 llama
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def weights():
    jcfg = jget_config("llama3.2-1b").reduced(**F16)
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    jcfg32 = jget_config("llama3.2-1b").reduced()
    jparams32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                       jparams)
    cfg = get_config("llama3.2-1b").reduced(**F16)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, jcfg32, jparams32, cfg, params


def err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_f16_prefill_and_decode_within_the_reference_error(use_pallas):
    """The prefill's last logits and three teacher-forced decode steps'
    logits within ERR_RATIO × the reference's own float16 error against its
    float32 run on the widened weights."""
    jcfg, jparams, jcfg32, jparams32, cfg, params = weights()
    B, SEQ, STEPS = 2, 48, 3
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (B, SEQ), dtype=np.int32)
    stream = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
    max_len = SEQ + STEPS
    runs = {}
    for key, c, p in (("h", jcfg.replace(use_pallas=use_pallas), jparams),
                      ("32", jcfg32, jparams32)):
        last, cache = jax.jit(lambda p_, x, c_=c: jmodel.prefill(
            p_, c_, {"tokens": x}, max_len=max_len))(p, prompts)
        dec = jax.jit(lambda p_, ca, t, pos, c_=c: jmodel.decode_step(
            p_, c_, ca, t, pos))
        out = [np.asarray(last.astype(jnp.float32))]
        for t in range(STEPS):
            logits, cache = dec(p, cache, jnp.asarray(stream[:, t:t + 1]),
                                jnp.asarray(SEQ + t, jnp.int32))
            out.append(np.asarray(logits.astype(jnp.float32)))
        runs[key] = out
    c = cfg.replace(use_pallas=use_pallas)
    with torch.no_grad():
        last, cache = model.prefill(params, c, {"tokens": torch.from_numpy(
            prompts)}, max_len=max_len)
        got = [last]
        for t in range(STEPS):
            logits, cache = model.decode_step(
                params, c, cache, torch.from_numpy(stream[:, t:t + 1]),
                SEQ + t)
            got.append(logits)
    for i, g in enumerate(got):
        assert g.dtype == torch.float16
        g = g.float().numpy()
        assert np.isfinite(g).all()
        assert err(g, runs["32"][i]) <= ERR_RATIO * err(
            runs["h"][i], runs["32"][i]), i
