"""The wide flash kernels (head_dim above 256) against the LIVE JAX
reference on the CPU.

The kernels run only on the card (``tests/test_torch_f16_cuda.py`` holds
them to their plain version there); what the CPU holds is their
arithmetic, emulated here and held against the reference's Pallas kernel
``flash_attention_padded`` in interpret mode, on the same numpy inputs:

- The head_dim is padded to a multiple of 8 (``wide_head_dim``), then to
  the columns of the instantiation that takes it (384 or 512,
  ``WIDE_HEAD_DIMS``); above 512 in slabs of 512.  Zero columns add exactly
  0 to every score.
- float32: split TF32 (``split_mm``), each warp's partial scores over its
  128 columns of every slab (16 columns at a time, added in float32), the
  warps' partials added in column-warp order, then the scale; P·V in split
  TF32.  Within ``ATTN_TOL`` of the reference.
- bfloat16 and float16: each of the two warpgroups' partial scores over its
  64-column chunks of every slab (one 2-byte product, float32 sums of
  16-column k steps), the two added, then the scale; P split into three
  bfloat16 terms, or two float16 terms scaled by 2^14 and 2^26, as the
  tensor-core kernels split it.  Within one ulp (+ 1e-6) of the
  reference's kernel on the widened inputs, rounded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as fa_ops
from repro.kernels.flash_attention import ref as fa_ref

from repro_torch.kernels.flash_attention import flash_attention as t_fa
from repro_torch.kernels.flash_attention import ref as t_fa_ref

from test_torch_f16 import (f16_inputs, f16_round, p_phases, pallas_f16,
                            within_one_f16_ulp)
from test_torch_kernels import (ATTN_TOL, attn_inputs, bf16_inputs,
                                bf16_round, float32_sum, k16_products,
                                live_rows, max_err, p_terms, pallas_bf16,
                                split_mm, within_one_bf16_ulp)

#: 260: padded to 264; 320 and 512: each instantiation; 600: above the
#: largest, two slabs of 512 columns
WIDE_HDS = (260, 320, 512, 600)
CASES = [(129, 129, True, None), (72, 40, True, 16), (65, 130, False, None),
         (130, 65, True, 100)]


def wide_columns(hd: int):
    """(the padded head_dim, the columns a block takes, slabs)."""
    hdw = t_fa.wide_head_dim(hd)
    oc = next((c for c in t_fa.WIDE_HEAD_DIMS if hdw <= c),
              t_fa.WIDE_HEAD_DIMS[-1])
    return hdw, oc, -(-hdw // oc)


def emulated_wide(q, k, v, *, causal, window, dtype):
    """The wide kernel's attention on numpy inputs that hold ``dtype``'s
    values (float32 arrays): scores as partial products per warp (float32)
    or warpgroup (2-byte) added in a fixed order, then the scale; masked
    scores -1e30 with weight 0; P·V as the tensor-core kernels run it;
    o = acc / max(l, 1e-30), rounded to ``dtype``."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    k, v = (torch.repeat_interleave(t, H // KV, dim=2) for t in (k, v))
    _, oc, ns = wide_columns(hd)
    pad = ns * oc - hd
    q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    qs, kt = q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    parts = []
    if dtype == "float32":
        for c in range(oc // 128):                 # the column warps
            steps = [split_mm(qs[..., c0:c0 + 16], kt[..., c0:c0 + 16, :])
                     for p in range(ns)
                     for c0 in range(p * oc + 128 * c,
                                     p * oc + 128 * c + 128, 16)]
            parts.append(float32_sum(steps))
    else:
        cw = oc // 128                             # 64-column chunks a WG
        for w in range(2):                         # the warpgroups
            steps = [st for p in range(ns)
                     for c in range(w * cw, (w + 1) * cw)
                     for st in k16_products(
                         qs[..., p * oc + 64 * c:p * oc + 64 * c + 64],
                         kt[..., p * oc + 64 * c:p * oc + 64 * c + 64, :])]
            parts.append(float32_sum(steps))
    s = float32_sum(parts) * scale
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
    vh = v.permute(0, 2, 1, 3)
    if dtype == "float32":
        o = split_mm(p, vh)
    else:
        kpad = -Skv % 16                           # keys past Skv: p 0, v 0
        vh = torch.nn.functional.pad(vh, (0, 0, 0, kpad))
        if dtype == "bfloat16":
            phases = [(1.0, p_terms(p)[::-1])]
        else:                                      # lo, then hi: two waits
            out_scale, hi, (lo_scale, lo) = p_phases(p, 2, True)
            phases = [(lo_scale, lo), (out_scale, hi)]
        o = None
        for sc, terms in phases:
            steps = [k16_products(torch.nn.functional.pad(t, (0, kpad)), vh)
                     for t in terms]
            for kk in range(steps[0].shape[0]):
                for st in steps:
                    o = st[kk] if o is None else o + st[kk]
            o = o * sc
    o = o / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    if dtype == "bfloat16":
        o = bf16_round(o)
    elif dtype == "float16":
        o = f16_round(o)
    return o.permute(0, 2, 1, 3)[..., :hd].numpy()


def inputs(S, Skv, hd, dtype):
    q, k, v = attn_inputs(S, Skv, B=1, H=4, KV=2, hd=hd,
                          seed=S * 3 + Skv + hd)
    if dtype == "bfloat16":
        return bf16_inputs(q, k, v)
    if dtype == "float16":
        return f16_inputs(q, k, v)
    return q, k, v


@pytest.mark.parametrize("hd", WIDE_HDS)
@pytest.mark.parametrize("S,Skv,causal,window", CASES)
def test_wide_split_tf32_matches_reference(S, Skv, causal, window, hd):
    q, k, v = inputs(S, Skv, hd, "float32")
    got = emulated_wide(q, k, v, causal=causal, window=window,
                        dtype="float32")
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = fa_ops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window)            # interpret
    oracle = fa_ref.attention(jq, jk, jv, causal=causal, window=window)
    got, pallas, oracle = live_rows(S, Skv, window, got, pallas, oracle)
    assert max_err(got, pallas) < ATTN_TOL
    assert max_err(got, oracle) < ATTN_TOL


@pytest.mark.parametrize("hd", WIDE_HDS)
@pytest.mark.parametrize("S,Skv,causal,window", CASES)
def test_wide_bf16_within_one_ulp_of_reference(S, Skv, causal, window, hd):
    q, k, v = inputs(S, Skv, hd, "bfloat16")
    got = emulated_wide(q, k, v, causal=causal, window=window,
                        dtype="bfloat16")
    want = pallas_bf16(q, k, v, causal=causal, window=window)
    got, want = live_rows(S, Skv, window, got, want)
    assert within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("hd", WIDE_HDS)
@pytest.mark.parametrize("S,Skv,causal,window", CASES)
def test_wide_f16_within_one_ulp_of_reference(S, Skv, causal, window, hd):
    q, k, v = inputs(S, Skv, hd, "float16")
    got = emulated_wide(q, k, v, causal=causal, window=window,
                        dtype="float16")
    want = pallas_f16(q, k, v, causal=causal, window=window)
    got, want = live_rows(S, Skv, window, got, want)
    assert within_one_f16_ulp(got, want)


def test_wide_f16_on_the_dominant_key_rows():
    """At head_dim 320 the scaled P split keeps the weights below 2^-24
    (every key but key 0 about e^-18 behind it), as at 64."""
    S, hd = 256, 320
    rng = np.random.default_rng(11)
    q = np.zeros((1, S, 2, hd), np.float32)
    q[..., 0] = 6.0
    k = (0.01 * rng.standard_normal((1, S, 1, hd))).astype(np.float32)
    k[:, 0, :, 0] = 54.0                 # 6 · 54 · 320^-0.5 = 18.1
    v = rng.random((1, S, 1, hd)).astype(np.float32)
    v[:, 0] = 0.0
    q, k, v = f16_inputs(q, k, v)
    want = pallas_f16(q, k, v, causal=True, window=None)
    got = emulated_wide(q, k, v, causal=True, window=None, dtype="float16")
    assert float(np.abs(want).max()) > 1e-6
    assert within_one_f16_ulp(got, want)


@pytest.mark.parametrize("hd,hdw,oc,ns", [(257, 264, 384, 1),
                                          (320, 320, 384, 1),
                                          (384, 384, 384, 1),
                                          (385, 392, 512, 1),
                                          (512, 512, 512, 1),
                                          (600, 600, 512, 2),
                                          (1025, 1032, 512, 3)])
def test_wide_head_dim_padding_and_slabs(hd, hdw, oc, ns):
    assert wide_columns(hd) == (hdw, oc, ns)
    q, k, v = map(torch.from_numpy, attn_inputs(5, 7, B=1, hd=hd))
    qp, kp, vp = t_fa.pad_head_dim(q, k, v)
    assert qp.shape[-1] == hdw and torch.equal(qp[..., :hd], q)
    assert not kp[..., hd:].any() and not vp[..., hd:].any()


@pytest.mark.parametrize("hd", [1, 64, 256])
def test_wide_head_dim_refuses_the_built_head_dims(hd):
    with pytest.raises(ValueError, match="takes the built instantiations"):
        t_fa.wide_head_dim(hd)


def test_wide_zero_padding_is_the_reference_function():
    """Attention on the operands zero-padded to the 512-column slab, with
    the true scale, cut back: the reference's kernel at head_dim 300."""
    q, k, v = attn_inputs(65, 65, B=1, hd=300, seed=5)
    qp, kp, vp = (torch.nn.functional.pad(torch.from_numpy(a), (0, 212))
                  for a in (q, k, v))
    got = t_fa_ref.attention(qp, kp, vp, causal=True, scale=300 ** -0.5)
    assert not got[..., 300:].any()
    pallas = fa_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=True)
    assert max_err(got[..., :300], pallas) < ATTN_TOL


def test_wide_instantiations_and_their_shared_memory():
    """Two instantiations in each dtype, each within Hopper's 227 KB a
    block: float32 two row groups of 16 query rows x 3 or 4 warps of 128
    columns (the 512 one 224 KB: three ring stages of 32 KB, q's hi and lo
    fragments 128 KB); 2-byte two consumer warpgroups of 64 rows x 192 or
    256 columns (the 512 one 225 KB: q 64 KB, two stages of K and V 128 KB,
    the exchange 32 KB)."""
    assert t_fa.WIDE_HEAD_DIMS == (384, 512)
    assert t_fa.WIDE_SHARED_BYTES == {384: 172032, 512: 229376}
    assert t_fa.WIDE_SHARED_BYTES_BF16 == {384: 181376, 512: 230528}
    for table in (t_fa.WIDE_SHARED_BYTES, t_fa.WIDE_SHARED_BYTES_BF16):
        assert all(b <= 232448 for b in table.values())
    for dt, (name, entry) in t_fa.WIDE_ENTRIES.items():
        assert entry in t_fa.LIBRARIES[dt].entry_points
        assert name in t_fa.LAUNCHES
