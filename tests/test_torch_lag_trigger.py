"""The legacy per-leaf comm route of the port (``use_pallas_comm``) against
the JAX reference.

The plain versions of the five ``lag_trigger`` kernels (``ref``, the route
``ops`` takes for CPU tensors) against the reference's Pallas kernels in
interpret mode, through both packages' ``ops``, on the same numpy inputs
and the shapes and dtypes of the reference's own kernel tests.
Tolerances: the sums within ``SUM_RTOL``, the reference's own; the masked
update and the absmax bit for bit; the LAQ steps bit for bit against each
side's own formula (the port divides, XLA-CPU multiplies by the
reciprocal: :func:`check_laq_leaf`), payloads bit for bit as codes × step,
codes equal off rounding boundaries, and the residual within the payload's
difference plus one ulp of |v| (XLA-CPU contracts ``v − codes·step`` into
a fused multiply-add in some elements, the port never does).  Then the
policy plumbing that selects the route, and a count of what one trainer
round calls on it.  The kernels themselves run only on the card: their
``cuda`` cases are ``tests/test_torch_lag_trigger_cuda.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lag as jlag
from repro.kernels.lag_trigger import lag_trigger as jkernels
from repro.kernels.lag_trigger import ops as jops

from repro_torch import comm
from repro_torch.configs import get_config
from repro_torch.core import lag
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.fastpath import kernels as plane_kernels
from repro_torch.kernels.lag_trigger import lag_trigger, ops, ref

SHAPES = [(64,), (1000,), (257, 33), (4, 8, 9, 5)]
DTYPES = ["float32", "bfloat16"]
SUM_RTOL = 2e-5
RESID_ULPS = 1


def operand(shape, seed, dtype="float32", scale=1.0):
    """The same values as a jnp array and a torch tensor (bfloat16 by
    round-to-nearest-even from the same float32 values, in both)."""
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def bits_of(x):
    """Raw bits of a jnp array or torch tensor (float32 or bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x.view(torch.int32)).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


# ---------------------------------------------------------------------------
# Plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_sqnorm_matches_pallas(shape, dtype):
    (ja, ta), (jb, tb) = operand(shape, 0, dtype), operand(shape, 1, dtype)
    got = ops.delta_sqnorm(ta, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(jops.delta_sqnorm(ja, jb)),
                               rtol=SUM_RTOL)


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_tree_sqnorm_matches_pallas(shape, dtype):
    ja, ta = operand(shape, 2, dtype)
    np.testing.assert_allclose(float(ops.fused_tree_sqnorm(ta)),
                               float(jops.fused_tree_sqnorm(ja)),
                               rtol=SUM_RTOL)


@pytest.mark.parametrize("mask", [0.0, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_update_matches_pallas_bitwise(mask, dtype):
    """m ∈ {0, 1} makes m·(a − b) exact, so no FMA can move a bit."""
    (ja, ta), (jb, tb) = (operand((130, 7), s, dtype) for s in (0, 1))
    got = ops.masked_lazy_update(ta, tb, torch.tensor(mask))
    want = jops.masked_lazy_update(ja, jb, jnp.asarray(mask))
    assert got.dtype == tb.dtype and got.shape == tb.shape
    assert np.array_equal(bits_of(got), bits_of(want))
    if not mask:
        assert torch.equal(got, tb)


def laq_inputs(shape):
    return (operand(shape, 10), operand(shape, 11, scale=0.25),
            operand(shape, 12, scale=0.01))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_innovation_absmax_matches_pallas_bitwise(shape):
    (jg, tg), (jq, tq), (je, te) = laq_inputs(shape)
    want = jkernels.innovation_absmax_2d(
        *(jops._to_2d(x) for x in (jg, jq, je)), interpret=True)
    assert np.array_equal(bits_of(ref.innovation_absmax(tg, tq, te)),
                          bits_of(want))


def check_laq_leaf(v, p, r, step, jp, jr, jstep, scale, bits):
    """One leaf of the port's LAQ encode against the reference's.

    The port's step is the IEEE division scale/qmax (the kernel's
    ``__fdiv_rn``); the reference's, inside ``jax.jit`` on XLA-CPU, is
    scale × f32(1/qmax): XLA rewrites a division by a constant into a
    multiply by its reciprocal, which differs in the last bit for about
    half of all scales at qmax 7.  Both are checked bit for bit against
    their own formula.  Each side's payload is whole codes × its own step;
    the codes are equal, except where the reference's v/step sits at a
    rounding boundary, which a last-bit step difference can flip.  The
    residual v − p then moves with p, plus XLA's fused multiply-add."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    scale = np.float32(scale)
    assert np.float32(step) == np.float32(np.float64(scale) / qmax)
    assert np.float32(jstep) == scale * np.float32(1.0 / qmax)
    p, jp, r, jr = (np.asarray(x, np.float32) for x in (p, jp, r, jr))
    if scale == 0.0:
        assert not p.any() and not jp.any()
        return
    codes = np.round(p / np.float32(step))
    jcodes = np.round(jp / np.float32(jstep))
    assert np.abs(codes).max() <= qmax
    assert np.array_equal(bits_of(p), bits_of(codes * np.float32(step)))
    assert np.array_equal(bits_of(jp), bits_of(jcodes * np.float32(jstep)))
    frac = np.abs(v * (np.float32(1.0) / np.float32(jstep)))
    frac = np.abs(frac - np.floor(frac) - 0.5)
    assert np.all((codes == jcodes) | (frac < 1e-5))
    assert np.all(np.abs(r - jr) <= np.abs(p - jp)
                  + RESID_ULPS * np.spacing(np.abs(v)))


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_laq_encode_matches_pallas(shape, bits):
    (jg, tg), (jq, tq), (je, te) = laq_inputs(shape)
    jp, jr, jlhs, jsteps = jops.laq_encode(jg, jq, je, bits=bits,
                                           use_ref=False, return_steps=True)
    p, r, lhs, steps = ops.laq_encode(tg, tq, te, bits=bits,
                                      return_steps=True)
    assert steps.shape == (1,) and steps.dtype == torch.float32
    check_laq_leaf((tg - tq + te).numpy(), p, r, steps[0], jp, jr,
                   jsteps[0], ref.innovation_absmax(tg, tq, te), bits)
    np.testing.assert_allclose(float(lhs), float(jlhs), rtol=SUM_RTOL)


def tree_pair(seed, scale=1.0):
    """A ragged pytree whose insertion order differs from JAX's sorted
    order, as numpy → (jnp tree, torch tree)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    t = {"z": mk(33), "b": {"y": mk(4, 5), "a": mk(1000)}, "m": [mk(257, 3)]}
    return (jax.tree_util.tree_map(jnp.asarray, t),
            jax.tree_util.tree_map(torch.from_numpy, t))


def test_pytree_entry_points_match_pallas():
    (ja, ta), (jb, tb), (je, te) = tree_pair(0), tree_pair(1), tree_pair(
        2, 0.01)
    ones = {"x": torch.ones(33), "y": {"z": torch.full((4, 5), 2.0)}}
    assert float(ops.delta_sqnorm(ones, jax.tree_util.tree_map(
        torch.zeros_like, ones))) == 33 + 4 * 5 * 4.0
    np.testing.assert_allclose(float(ops.delta_sqnorm(ta, tb)),
                               float(jops.delta_sqnorm(ja, jb)),
                               rtol=SUM_RTOL)
    np.testing.assert_allclose(float(ops.fused_tree_sqnorm(ta)),
                               float(jops.fused_tree_sqnorm(ja)),
                               rtol=SUM_RTOL)
    upd = ops.masked_lazy_update(ta, tb, torch.tensor(True))
    jupd = jops.masked_lazy_update(ja, jb, jnp.asarray(True))
    for a, b in zip(jax.tree_util.tree_leaves(upd),
                    jax.tree_util.tree_leaves(jupd)):
        assert np.array_equal(bits_of(a), bits_of(b))
    p, r, lhs, steps = ops.laq_encode(ta, tb, te, bits=4, return_steps=True)
    jp, jr, jlhs, jsteps = jops.laq_encode(ja, jb, je, bits=4,
                                           return_steps=True, use_ref=False)
    leaves = [jax.tree_util.tree_leaves(t) for t in (ta, tb, te, p, r, jp,
                                                     jr)]
    assert steps.shape == (len(leaves[0]),)
    for i, (g, q, e, pi, ri, jpi, jri) in enumerate(zip(*leaves)):
        check_laq_leaf((g - q + e).numpy(), pi, ri, steps[i], jpi, jri,
                       jsteps[i], ref.innovation_absmax(g, q, e), 4)
    np.testing.assert_allclose(float(lhs), float(jlhs), rtol=SUM_RTOL)
    assert float(ops.fused_tree_sqnorm({})) == 0.0


@pytest.mark.parametrize("rule", ["wk", "ps"])
def test_trigger_rules_with_injected_norm_match_reference(rule):
    (ja, ta), (jb, tb) = tree_pair(3), tree_pair(4)
    jb = jax.tree_util.tree_map(lambda a, b: a + 0.01 * b, ja, jb)
    tb = jax.tree_util.tree_map(lambda a, b: a + 0.01 * b, ta, tb)
    lhs = float(ops.delta_sqnorm(ta, tb))
    L = np.float32(3.0)
    for scale in (0.5, 2.0):          # the RHS below, then above the LHS
        drift = lhs * (L ** 2 if rule == "ps" else 1.0)
        hist = np.full((4,), scale * drift * 0.01 * 4 / (0.25 * 4),
                       np.float32)
        jc = jlag.LAGConfig(num_workers=2, alpha=0.1, D=4, xi=0.25)
        c = lag.LAGConfig(num_workers=2, alpha=0.1, D=4, xi=0.25)
        if rule == "wk":
            want = jlag.wk_communicate(ja, jb, hist, jc,
                                       sqnorm_fn=jops.fused_tree_sqnorm)
            got = lag.wk_communicate(ta, tb, torch.from_numpy(hist), c,
                                     sqnorm_fn=ops.fused_tree_sqnorm)
        else:
            want = jlag.ps_communicate(ja, jb, jnp.asarray(L), hist, jc,
                                       sqnorm_fn=jops.fused_tree_sqnorm)
            got = lag.ps_communicate(ta, tb, torch.tensor(L),
                                     torch.from_numpy(hist), c,
                                     sqnorm_fn=ops.fused_tree_sqnorm)
        assert bool(got) == bool(want) == (scale < 1.0)


# ---------------------------------------------------------------------------
# Policy plumbing: use_pallas selects the route, the plane stays off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["gd", "lag-wk", "lag-ps", "laq@4"])
def test_use_pallas_selects_the_per_leaf_route(spec):
    pol = comm.make_policy(spec, use_pallas=True,
                           sqnorm_fn=ops.fused_tree_sqnorm)
    assert pol.fastpath is None
    assert pol.sqnorm_fn is ops.fused_tree_sqnorm
    plain = comm.make_policy(spec)
    assert plain.fastpath.mode == "auto" and plain.sqnorm_fn is \
        lag.tree_sqnorm
    if spec.startswith("laq"):
        assert pol.use_pallas and not plain.use_pallas
    tcfg = TrainerConfig(algo=spec, num_workers=2, use_pallas_comm=True)
    pol = tcfg.comm_policy()
    assert pol.fastpath is None and pol.sqnorm_fn is ops.fused_tree_sqnorm
    assert TrainerConfig(algo=spec).comm_policy().sqnorm_fn is \
        lag.tree_sqnorm


def test_conflicting_comm_plane_configs_raise():
    with pytest.raises(ValueError, match="conflicting comm-plane"):
        comm.make_policy("lag-wk", use_pallas=True, fastpath="on")
    with pytest.raises(ValueError, match="conflicting comm-plane"):
        TrainerConfig(algo="laq@4", use_pallas_comm=True, fastpath="on")
    with pytest.raises(ValueError, match="fastpath mode"):
        # the user still has no "off" mode
        comm.make_policy("lag-wk", use_pallas=True, fastpath="off")
    # None (no plan) agrees with use_pallas, which selects no plan either
    assert comm.make_policy("lag-wk", use_pallas=True,
                            fastpath=None).fastpath is None


@pytest.mark.parametrize("algo", ["lag-wk", "lag-ps", "laq@4"])
def test_one_round_calls_the_per_leaf_ops_once_per_worker(algo, monkeypatch):
    """Under ``use_pallas_comm`` a trainer round calls the per-leaf entry
    point once per worker and no kernel of the batched plane."""
    calls = {"fused_tree_sqnorm": 0, "laq_encode": 0, "plane": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in ("fused_tree_sqnorm", "laq_encode"):
        monkeypatch.setattr(ops, name, counting(name, getattr(ops, name)))
    for name in plane_kernels.ENTRIES:
        monkeypatch.setattr(plane_kernels, name,
                            counting("plane", getattr(plane_kernels, name)))
    cfg = get_config("llama3.2-1b").reduced().replace(num_layers=1)
    tcfg = TrainerConfig(algo=algo, num_workers=2, lr=0.3,
                         use_pallas_comm=True)
    state = init_state(cfg, tcfg, device="cpu", seed=1)
    step = make_train_step(cfg, tcfg)
    state, m = step(state, make_inputs(cfg, TokenStream(cfg.vocab_size), 0,
                                       2, 8, device="cpu"))
    laq = algo.startswith("laq")
    assert calls == {"fused_tree_sqnorm": 0 if laq else 2,
                     "laq_encode": 2 if laq else 0, "plane": 0}
    assert m["comm_mask"].tolist() == [True, True]


# ---------------------------------------------------------------------------
# The CUDA wrappers take CUDA tensors only
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor is the dispatcher's business: the wrapper raises."""
    x = torch.ones(1000)
    for call in (lambda: lag_trigger.sqnorm_2d(x),
                 lambda: lag_trigger.delta_sqnorm_2d(x, x),
                 lambda: lag_trigger.masked_update_2d(x, x, torch.ones(())),
                 lambda: lag_trigger.innovation_absmax_2d(x, x, x),
                 lambda: lag_trigger.laq_encode_2d(x, x, x, torch.ones(()),
                                                   4)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    lag_trigger.reset_launches()
    ops.fused_tree_sqnorm(x)
    ops.laq_encode(x, x, x)
    assert all(v == 0 for v in lag_trigger.LAUNCHES.values())
