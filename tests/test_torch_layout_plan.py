"""The port's flat layout, kernel plain versions and plan reductions held
against the JAX reference (``repro.fastpath``), plus the import tripwire.

The same numpy inputs go through both packages.  The Pallas kernels run in
interpret mode, as the reference's own tests run them on the CPU.
Tolerances: bitwise for layouts, masked folds, the absmax sweep and the
LAQ payload/codes; ``SUM_RTOL`` for per-sub-block sums (the two packages
add the 1024 squares of a sub-block in different orders); the LAQ
residual ``v − codes·step`` within ``RESID_ULPS`` ulps of |v| (XLA-CPU may
contract it into a fused multiply-add, the port never does).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fastpath import kernels as jk
from repro.fastpath.layout import FlatLayout as JFlatLayout
from repro.fastpath.plan import FastPathPlan as JPlan

from cuda_helpers import RAGGED, np_tree
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.fastpath import kernels, kernels_ref
from repro_torch.fastpath.layout import BLOCK, LANES, FlatLayout
from repro_torch.fastpath.plan import FastPathPlan, make_plan

SUM_RTOL = 1e-5
RESID_ULPS = 1
SRC = Path(__file__).resolve().parents[1] / "src"


def to_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Tripwire: the port imports neither jax nor repro
# ---------------------------------------------------------------------------

def test_port_imports_without_jax_or_repro():
    code = textwrap.dedent(f"""
        import sys, pkgutil, importlib
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {str(SRC)!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        for want in ("repro_torch.fastpath.kernels",
                     "repro_torch.kernels.lag_trigger.ops",
                     "repro_torch.core.convex", "repro_torch.core.simulate",
                     "repro_torch.engine.experiment",
                     "repro_torch.engine.report",
                     "repro_torch.engine.topology",
                     "repro_torch.netsim.cluster",
                     "repro_torch.netsim.hetero"):
            assert want in names, (want, names)
        from repro_torch.engine import Experiment, SimWorkers
        from repro_torch.netsim import make_cluster, hetero_problem
        print(len(names))
        """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def test_leaf_order_is_jax_order():
    t = np_tree()
    port = tree_leaves(t)
    ref = jax.tree_util.tree_leaves(t)
    assert len(port) == len(ref) == 5
    assert all(a is b for a, b in zip(port, ref))


@pytest.mark.parametrize("sizes", [RAGGED, (3 * BLOCK + 5, 0, 7, 1, 1024),
                                   (0, 0, 0, 0, 1)])
def test_layout_tables_match_reference(sizes):
    t = np_tree(sizes=sizes)
    lo = FlatLayout.for_tree(to_torch(t))
    jlo = JFlatLayout.for_tree(t)
    assert lo.rows == jlo.rows
    assert lo.nsubs == jlo.nsubs and lo.nblocks == jlo.nblocks
    assert lo.leaf_sub_offsets == jlo.leaf_sub_offsets
    assert lo.leaf_subs == jlo.leaf_subs and lo.sizes == jlo.sizes
    np.testing.assert_array_equal(lo.sub_leaf, jlo.sub_leaf)


@pytest.mark.parametrize("W", [None, 1, 3])
def test_flatten_and_round_trip_bitwise(W):
    t = np_tree(W=W, seed=W or 0)
    unstacked = np_tree() if W else t
    lo = FlatLayout.for_tree(to_torch(unstacked))
    jlo = JFlatLayout.for_tree(unstacked)
    if W is None:
        buf, jbuf = lo.flatten(to_torch(t)), jlo.flatten(t)
        back = lo.unflatten(buf)
    else:
        buf, jbuf = lo.flatten_stacked(to_torch(t)), jlo.flatten_stacked(t)
        back = lo.unflatten_stacked(buf)
    assert bits_equal(buf.numpy(), jbuf)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(t)):
        assert bits_equal(a.numpy(), b)


def test_unflatten_float32_returns_views():
    lo = FlatLayout.for_tree(to_torch(np_tree()))
    buf = lo.empty()
    views = tree_leaves(lo.unflatten(buf))
    views[0].fill_(3.0)
    assert float(buf.view(-1)[lo.leaf_sub_offsets[0] * 1024]) == 3.0
    leaves, _ = tree_flatten(lo.unflatten(buf, like=torch.bfloat16))
    assert all(l.dtype == torch.bfloat16 for l in leaves)


# ---------------------------------------------------------------------------
# Kernel plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def flat_inputs(W, n_ops, seed, sizes=RAGGED, scale=1.0):
    """n_ops stacked (W, rows, 128) float32 buffers of one ragged layout."""
    lo = JFlatLayout.for_tree(np_tree(sizes=sizes))
    return lo, [np.array(lo.flatten_stacked(np_tree(W=W, seed=seed + i,
                                                      sizes=sizes,
                                                      scale=scale)))
                for i in range(n_ops)]


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("stacked_b", [True, False])
def test_delta_sqnorm_blocks_matches_pallas(W, stacked_b):
    lo, (a, b) = flat_inputs(W, 2, seed=10 * W)
    if not stacked_b:
        b = b[0]
    ref = np.asarray(jk.delta_sqnorm_blocks(jnp.asarray(a), jnp.asarray(b),
                                            interpret=True))
    got = kernels.delta_sqnorm_blocks(torch.from_numpy(a),
                                      torch.from_numpy(b)).numpy()
    assert got.shape == ref.shape == (W, lo.rows // 8)
    np.testing.assert_allclose(got, ref, rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("W", [1, 3])
def test_sqnorm_blocks_matches_pallas(W):
    lo, (a,) = flat_inputs(W, 1, seed=15 * W)
    ref = np.asarray(jk.sqnorm_blocks(jnp.asarray(a), interpret=True))
    got = kernels.sqnorm_blocks(torch.from_numpy(a)).numpy()
    assert got.shape == ref.shape == (W, lo.rows // 8)
    np.testing.assert_allclose(got, ref, rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("W", [1, 3])
def test_absmax_blocks_matches_pallas_bitwise(W):
    _, (g, q, e) = flat_inputs(W, 3, seed=20 + W)
    ref = jk.absmax_blocks(*map(jnp.asarray, (g, q, e)), interpret=True)
    got = kernels.absmax_blocks(*map(torch.from_numpy, (g, q, e)))
    assert bits_equal(got.numpy(), ref)


def _ulp_of(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_laq_encode_blocks_matches_pallas(W, bits):
    lo, (g, q, e) = flat_inputs(W, 3, seed=30 + W + bits)
    e = e * np.float32(0.1)
    # steps from the plan's per-leaf absmax, shared by both sides
    parts = np.asarray(jk.absmax_blocks(*map(jnp.asarray, (g, q, e)),
                                        interpret=True))
    steps = np.asarray(JPlan._per_leaf(jnp.asarray(parts), lo, "max")) \
        / np.float32(2 ** (bits - 1) - 1)
    steps_subs = np.ascontiguousarray(steps[:, lo.sub_leaf])
    steps_subs = np.where(np.isfinite(steps_subs), steps_subs,
                          0).astype(np.float32)
    jp, jr, jsq = jk.laq_encode_blocks(*map(jnp.asarray, (g, q, e)),
                                       jnp.asarray(steps_subs), bits,
                                       interpret=True)
    p, r, sq = kernels.laq_encode_blocks(*map(torch.from_numpy, (g, q, e)),
                                         torch.from_numpy(steps_subs), bits)
    assert bits_equal(p.numpy(), jp)                  # payload = codes·step
    qmax = 2 ** (bits - 1) - 1
    st = np.repeat(steps_subs, 8, axis=1)[:, :, None]
    # codes recover as round(payload / step), the wire format's decode
    codes = np.where(st > 0, p.numpy() / np.where(st > 0, st, 1), 0)
    assert np.all(np.abs(np.round(codes)) <= qmax)
    assert np.max(np.abs(codes - np.round(codes))) < 1e-3
    v = (g - q) + e
    assert np.all(np.abs(r.numpy() - np.asarray(jr))
                  <= RESID_ULPS * _ulp_of(v))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=SUM_RTOL)


@pytest.mark.parametrize("mode", ["add", "update", "select"])
@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("stacked_a", [True, False])
def test_masked_combine_matches_pallas_bitwise(mode, W, stacked_a):
    _, (a, b) = flat_inputs(W, 2, seed=40 + W)
    if not stacked_a:
        a = a[0]
    mask = np.array([True, False, True][:W])
    ref = jk.masked_combine(jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(mask), mode, interpret=True)
    got = kernels.masked_combine(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(mask), mode)
    assert bits_equal(got.numpy(), ref)


def test_cpu_wrappers_run_plain_versions_without_counting():
    _, (a, b) = flat_inputs(2, 2, seed=1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    kernels.reset_launches()
    out = tb.clone()
    res = kernels.masked_combine(ta, out, torch.tensor([True, False]), "add",
                                 out=out)
    assert res.data_ptr() == out.data_ptr()
    assert torch.equal(res, kernels_ref.masked_combine(
        ta, tb, torch.tensor([True, False]), "add"))
    kernels.delta_sqnorm_blocks(ta, tb)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_wrapper_argument_checks():
    a = torch.zeros((2, 256, LANES))
    with pytest.raises(TypeError):
        kernels.delta_sqnorm_blocks(a.double(), a.double())
    with pytest.raises(ValueError):
        kernels.delta_sqnorm_blocks(a[:, :250], a[:, :250])
    with pytest.raises(ValueError):
        kernels.masked_combine(a, a, torch.ones(3), "add")
    with pytest.raises(ValueError):
        kernels.masked_combine(a, a, torch.ones(2), "nope")


# ---------------------------------------------------------------------------
# Plan: fixed-order per-leaf reductions and the LAQ encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "max"])
def test_per_leaf_reduction_matches_reference(op):
    lo_j, (a,) = flat_inputs(3, 1, seed=5)
    lo = FlatLayout.for_tree(to_torch(np_tree()))
    parts = np.abs(a.reshape(3, -1, 1024)).sum(-1).astype(np.float32)
    ref = np.asarray(JPlan._per_leaf(jnp.asarray(parts), lo_j, op))
    got = FastPathPlan._per_leaf(torch.from_numpy(parts), lo, op).numpy()
    if op == "max":
        assert bits_equal(got, ref)                   # incl. −inf (empty)
    else:
        np.testing.assert_allclose(got, ref, rtol=SUM_RTOL)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plan_laq_encode_matches_reference(bits):
    W = 3
    tg, tq, te = (np_tree(W=W, seed=s) for s in (1, 2, 3))
    te = jax.tree_util.tree_map(lambda x: 0.1 * x, te)
    jp, jr, jlhs, jsteps = JPlan("on").laq_encode(tg, tq, te, bits=bits,
                                                   return_steps=True)
    lo = FlatLayout.for_tree(to_torch(np_tree()))
    g, q, e = (lo.flatten_stacked(to_torch(t)) for t in (tg, tq, te))
    p, r, lhs, steps = FastPathPlan("on").laq_encode(g, q, e, lo, bits=bits)
    assert bits_equal(steps.numpy(), jsteps)
    for a, b in zip(tree_leaves(lo.unflatten_stacked(p)),
                    jax.tree_util.tree_leaves(jp)):
        assert bits_equal(a.numpy(), b)
    np.testing.assert_allclose(lhs.numpy(), np.asarray(jlhs), rtol=SUM_RTOL)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plan_laq_steps_are_ieee_quotients(bits):
    """The plane's steps are the IEEE quotient scale / qmax bit for bit,
    the division of a tensor divisor (on CUDA a Python-scalar divisor
    becomes a multiply by the reciprocal; the card-side check is the
    ``cuda`` test in ``tests/test_torch_layout_plan_cuda.py`` and
    ``chip_smoke.py`` phase 6).  That they equal
    the reference's steps is ``test_plan_laq_encode_matches_reference``."""
    W = 3
    tg, tq, te = (np_tree(W=W, seed=s) for s in (4, 5, 6))
    lo = FlatLayout.for_tree(to_torch(np_tree()))
    g, q, e = (lo.flatten_stacked(to_torch(t)) for t in (tg, tq, te))
    plan = FastPathPlan("on")
    steps = plan.laq_encode(g, q, e, lo, bits=bits)[3]
    scales = plan._per_leaf(kernels_ref.absmax_blocks(g, q, e), lo, "max")
    qmax = float(2 ** (bits - 1) - 1)
    assert bits_equal(steps.numpy(), (scales / torch.tensor(qmax)).numpy())


@pytest.mark.parametrize("W", [1, 3])
def test_plan_sqnorm_matches_reference(W):
    t = np_tree(W=W, seed=W)
    ref = JPlan("on").sqnorm(t)
    lo = FlatLayout.for_tree(to_torch(np_tree()))
    got = FastPathPlan("on").sqnorm(lo.flatten_stacked(to_torch(t)), lo)
    assert got.shape == (W,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SUM_RTOL)


def test_plan_modes():
    auto, on = make_plan("auto"), make_plan("on")
    cpu = torch.zeros(1)
    assert not auto.enabled_for(cpu) and on.enabled_for(cpu)
    assert make_plan(on) is on
    for bad in ("sometimes", "off", None):
        with pytest.raises(ValueError):
            make_plan(bad)
