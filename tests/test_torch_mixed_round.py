"""A tree of bfloat16 and float32 leaves in the round, held to the LIVE
JAX reference; and the legacy per-leaf route at bfloat16.

The reference's bfloat16 configs keep float32 leaves (the MoE router,
mamba2's ``A_log``/``dt_bias``/``D``, RG-LRU's ``b_a``/``b_i``).  Its plane
casts every leaf to float32 and scatters each result back at the leaf's
own dtype; the port keeps two buffers a state (``fastpath.layout.
MixedLayout`` / ``Parts``), each at its leaves' dtype.

- The layout: a mixed tree round-trips bit for bit, each leaf a view of
  its part's buffer; a tree of one dtype keeps its one ``FlatLayout``
  buffer.  The plane's per-leaf sums, maxima and LAQ steps over the two
  parts equal those of one float32 layout of the widened tree: the maxima
  and steps bit for bit, the sums within rtol 1e-6 (each part's zero tail
  folds into that part's first leaf, which may move a sum's last bit).
- One round (W = 3; the plane ``fastpath="on"``, the plain route ``"auto"``
  and the legacy per-leaf route ``make_policy(use_pallas=True)``) against
  the reference's jitted round (its oracle route, and its legacy route with
  its Pallas kernels in interpret mode), with the trigger LHS far from the
  RHS: masks equal; ĝ, θ̂ and ∇ bit for bit; θ bit for bit on the bfloat16
  leaves and within rtol = atol = 1e-6 on the float32 leaves (XLA fuses
  θ − α·∇ into a multiply-add); the history within rtol 1e-6 (2⁻⁷ for
  Adam, ``test_torch_bf16_train.ADAM_HIST_RTOL``).  Where XLA-CPU computes
  something else (ROADMAP queue 3, "bfloat16 training"): gd's bfloat16 ∇
  and θ within the payloads' and the sum's roundings; LAQ's float32 leaves
  within 2⁻²⁰ of the leaf's largest |value| (XLA's encode is not IEEE; ∇
  within rtol = atol = 1e-6), its residual within 5e-7, its ∇ and θ (float32 in the reference, promoted by
  the payload) within one bfloat16 ulp on the bfloat16 leaves, and its
  bfloat16 ĝ one rounding on the planes, two on the plain routes, each
  bitwise its own route's.
- The legacy kernels' plain versions at each operand combination the CUDA
  kernels build, against the reference's Pallas kernels in interpret mode:
  the masked update and the absmax bit for bit, the LAQ payload and
  residual as ``test_torch_lag_trigger.check_laq_leaf`` holds them (equal
  codes on each side's own step: XLA-CPU's jitted step is scale ×
  f32(1/qmax), the port's the IEEE quotient), the sums within rtol 2e-5;
  an unbuilt combination raises ``TypeError`` on the CPU as on the card.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import lag as jlag
from repro.engine import rounds as jrounds
from repro.engine import server as jserver
from repro.fastpath.plan import FastPathPlan as JFastPathPlan
from repro.kernels.lag_trigger import lag_trigger as jkernels
from repro.kernels.lag_trigger import ops as jops

from repro_torch import comm
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.engine import rounds, server
from repro_torch.fastpath import kernels
from repro_torch.fastpath.layout import (BLOCK, FlatLayout, MixedLayout,
                                         Parts, dtype_of, layout_for, row)
from repro_torch.fastpath.plan import FastPathPlan
from repro_torch.kernels.lag_trigger import lag_trigger, ops, ref

from test_torch_lag_trigger import check_laq_leaf

BF, F32 = ml_dtypes.bfloat16, np.float32
W = 3
#: a mixed tree: a float32 leaf first in tree order (the float32 part's
#: zero tail folds into it), a leaf of one whole block, ragged leaves
SPEC = {"a": (1, F32), "b": {"k": (127, BF), "r": (129, F32)},
        "blk": [(BLOCK, BF)], "c": (3000, BF), "d": (5, F32)}
ADAM_HIST_RTOL = 2.0 ** -7
HIST_RTOL = 1e-6
LAQ_F32_REL = 2.0 ** -20
RESID_ATOL = 5e-7
#: float32 θ (and LAQ's float32 ∇) against XLA's fused multiply-adds: the
#: float32 trainer tests' tolerance (test_torch_bf16_train)
F32_RTOL = 1e-6
SUM_RTOL = 2e-5


def np_tree(lead=(), seed=0, scale=1.0, dt=None):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(lead + (s[0],))).astype(
            np.float32).astype(dt or s[1]), SPEC,
        is_leaf=lambda x: isinstance(x, tuple))


def near(tree, seed, s, dt=None):
    """``tree`` minus per-worker noise of size s_m (at ``dt``, default the
    leaf's own dtype)."""
    noise = np_tree((W,), seed, dt=np.float32)
    return jax.tree_util.tree_map(
        lambda x, n: (x.astype(np.float32) - np.asarray(s, np.float32)
                      .reshape((W,) + (1,) * (n.ndim - 1)) * n).astype(
            x.dtype if dt is None else dt), tree, noise)


def to_t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == BF:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tt(tree):
    return jax.tree_util.tree_map(to_t, tree)


def make_inputs(spec, ghdt=None):
    """(grads, state, θ, ∇, hist, ∇ℓ(θ̂)): worker 1 close to its mirror,
    the others far, every LHS far from the RHS."""
    grads = np_tree((W,), 1)
    st = {"grad_hat": near(grads, 2, (1.0, 0.01, 1.0), ghdt)}
    theta = np_tree((), 3)
    if spec in ("lag-ps", "lasg-wk"):
        st["theta_hat"] = near(jax.tree_util.tree_map(
            lambda t: np.broadcast_to(t, (W,) + t.shape), theta), 4,
            (0.05, 0.0005, 0.05))
    if "laq" in spec:
        st["resid"] = np_tree((W,), 5, scale=0.01, dt=np.float32)
    gah = near(grads, 6, (1.0, 0.01, 1.0)) if spec == "lasg-wk" else None
    nabla = jax.tree_util.tree_map(
        lambda x, t: np.sum(x.astype(np.float32), 0).astype(t.dtype),
        st["grad_hat"], theta)
    hist = np.full((4,), 0.03 if spec == "lag-ps" else 3.0, np.float32)
    return grads, st, theta, nabla, hist, gah


def stack(lo, tree, dt=None):
    """A stacked reference tree as the port's (W, rows, 128) buffer(s),
    each part at ``dt`` (default: its leaves' dtype)."""
    buf = lo.empty((W,), dtype=dt)
    t = tt(tree)
    for m in range(W):
        lo.flatten(tree_map(lambda x: x[m], t), out=row(buf, m))
    return buf


def single(lo, tree):
    return lo.flatten(tt(tree), out=lo.empty())


def leaves_of(lo, buf, stacked):
    """The port's buffer(s) as leaves (stacked over workers), each at its
    buffer's dtype."""
    if not stacked:
        return tree_leaves(lo.unflatten(buf, like=dtype_of(buf)))
    per = [tree_leaves(lo.unflatten(row(buf, m), like=dtype_of(buf)))
           for m in range(W)]
    return [torch.stack([p[i] for p in per]) for i in range(lo.num_leaves)]


def legacy_policy(pkg, spec, mode="auto"):
    if pkg == "ref":
        return jcomm.make_policy(spec, use_pallas=True,
                                 sqnorm_fn=jops.fused_tree_sqnorm,
                                 fastpath=mode)
    return comm.make_policy(spec, use_pallas=True,
                            sqnorm_fn=ops.fused_tree_sqnorm, fastpath=mode)


def lag_cfg(pkg, spec):
    mod = jlag if pkg == "ref" else lag
    return mod.LAGConfig(num_workers=W, alpha=0.1, D=4, xi=0.25,
                         rule="ps" if spec == "lag-ps" else "wk")


def run_reference(spec, srv, route, inputs):
    grads, st, theta, nabla, hist, gah = inputs
    jpol = legacy_policy("ref", spec) if route == "legacy" \
        else jcomm.make_policy(spec, fastpath=route)
    jsrv = jserver.make_server(srv)
    jls = dict(st, nabla=nabla, hist=hist,
               L_m=np.full((W,), 10.0, np.float32),
               comm_total=np.int32(0), comm_per_worker=np.zeros(W, np.int32))
    params = jax.tree_util.tree_map(jnp.asarray, theta)
    out = jax.jit(lambda p, o, ls, g, gh: jrounds.lag_round(
        jpol, jsrv, lag_cfg("ref", spec), params=p, opt_state=o,
        lag_state=ls, grads=g, step=jnp.int32(5), grad_at_hat=gh))(
            params, jsrv.init(params), jls, grads, gah)
    return jax.tree_util.tree_map(np.asarray, out)


def run_port(spec, srv, route, inputs, ghdt=None):
    grads, st, theta, nabla, hist, gah = inputs
    lo = layout_for(tt(theta))
    assert isinstance(lo, MixedLayout)
    ls = {"grad_hat": stack(lo, st["grad_hat"], ghdt)}
    if "theta_hat" in st:
        ls["theta_hat"] = stack(lo, st["theta_hat"])
    if "resid" in st:
        ls["resid"] = stack(lo, st["resid"], torch.float32)
    ls.update(nabla=single(lo, nabla), hist=torch.from_numpy(hist),
              L_m=torch.full((W,), 10.0),
              comm_total=torch.zeros((), dtype=torch.int32),
              comm_per_worker=torch.zeros(W, dtype=torch.int32))
    gl = None
    if gah is not None:
        gb = stack(lo, gah)
        gl = [gb] if route == "on" else [row(gb, m) for m in range(W)]
    pol = legacy_policy("port", spec) if route == "legacy" \
        else comm.make_policy(spec, fastpath=route)
    sv = server.make_server(srv)
    th = single(lo, theta)
    out = rounds.lag_round(pol, sv, lag_cfg("port", spec), theta=th,
                           layout=lo, opt_state=sv.init(th), lag_state=ls,
                           grads=stack(lo, grads), step=5, grad_at_hat=gl)
    return lo, out


def ulp(x: torch.Tensor, bits: int) -> torch.Tensor:
    """One ulp at |x| for ``bits`` significant bits (8 bfloat16, 24
    float32)."""
    _, e = torch.frexp(x.double().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - bits)


def within(got, want, bound, what):
    d = (got.double() - want.double()).abs()
    assert torch.all(d <= bound), (what, float((d - bound).max()))


def bitwise(got, want, what):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert torch.equal(got, want), (what, float(
        (got.double() - want.double()).abs().max()))


def check_leaves(what, got, want, rule):
    for i, (g, w) in enumerate(zip(got, jax.tree_util.tree_leaves(want))):
        rule(g, to_t(w), f"{what}[{i}]")


# ---------------------------------------------------------------------------
# The layout and the plane's reductions
# ---------------------------------------------------------------------------

def test_mixed_layout_round_trips_bitwise_as_views():
    tree = tt(np_tree((), 7))
    lo = layout_for(tree)
    assert isinstance(lo, MixedLayout)
    assert [p.dtype for p in lo.parts] == [torch.bfloat16, torch.float32]
    assert [p.num_leaves for p in lo.parts] == [3, 3]
    buf = lo.flatten(tree)
    assert isinstance(buf, Parts)
    assert (buf.b.dtype, buf.f.dtype) == (torch.bfloat16, torch.float32)
    assert buf.b.shape == (lo.parts[0].rows, 128)
    back = lo.unflatten(buf)
    for g, w in zip(tree_leaves(back), tree_leaves(tree)):
        bitwise(g, w, "round trip")
        part = buf.b if g.dtype == torch.bfloat16 else buf.f
        assert g.untyped_storage().data_ptr() \
            == part.untyped_storage().data_ptr()
    stacked = lo.flatten_stacked(tt(np_tree((W,), 8)))
    for g, w in zip(tree_leaves(lo.unflatten_stacked(stacked)),
                    tree_leaves(tt(np_tree((W,), 8)))):
        bitwise(g, w, "stacked round trip")
    # a tree of one dtype keeps its one buffer
    one = tree_map(lambda x: x.bfloat16(), tree)
    flo = layout_for(one)
    assert isinstance(flo, FlatLayout) and flo.dtype == torch.bfloat16
    assert isinstance(flo.flatten(one), torch.Tensor)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plane_reductions_over_two_parts_match_one_float32_layout(bits):
    """Per-part partials, ordered by leaf, equal the widened tree's float32
    layout's: maxima, steps, payloads and residuals bitwise, sums within
    rtol 1e-6; one launch a part (counted on the meta device by its
    outputs' shapes: (W, rows_p / 8) partials)."""
    g, q, e = (stack(layout_for(tt(np_tree((), 0))), t, dt) for t, dt in (
        (np_tree((W,), 1), None), (np_tree((W,), 2, 0.5), None),
        (np_tree((W,), 3, 0.01, np.float32), torch.float32)))
    lo = layout_for(tt(np_tree((), 0)))
    wide = FlatLayout.for_tree(tree_map(lambda x: x.float(),
                                        tt(np_tree((), 0))))
    widen = lambda buf: torch.stack([wide.flatten(tree_map(
        lambda x: x.float(), lo.unflatten(row(buf, m), like=dtype_of(buf))))
        for m in range(W)])
    plan = FastPathPlan("on")
    got = plan.delta_sqnorm(g, q, lo)
    want = plan.delta_sqnorm(widen(g), widen(q), wide)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    p, r, lhs, steps = plan.laq_encode(g, q, e, lo, bits=bits)
    wp, wr, wlhs, wsteps = plan.laq_encode(widen(g), widen(q), widen(e),
                                           wide, bits=bits)
    bitwise(steps, wsteps, "steps")
    assert steps.shape == (W, lo.num_leaves)
    bitwise(widen(p), wp, "payload")
    bitwise(widen(r), wr, "residual")
    np.testing.assert_allclose(lhs.numpy(), wlhs.numpy(), rtol=1e-6)
    # the reference's plane on the same tree: its sums in float32
    jplan = JFastPathPlan("on")
    jg, jq = np_tree((W,), 1), np_tree((W,), 2, 0.5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jplan.delta_sqnorm(jg, jq)), rtol=1e-5)


# ---------------------------------------------------------------------------
# One round against the reference
# ---------------------------------------------------------------------------

CASES = [("lag-wk", "sgd"), ("lag-ps", "sgd"), ("lasg-wk", "sgd"),
         ("lag-wk", "momentum@0.9"), ("lag-wk", "prox-l1@0.5"),
         ("lag-wk", "adam"), ("gd", "sgd"), ("laq@4", "sgd")]


def check_round(spec, srv, route, inputs, ref, port, ghdt=None):
    lo, (theta, _, ls, m) = port
    jtheta, _, jls, jm = ref
    np.testing.assert_array_equal(m["comm_mask"].numpy(), jm["comm_mask"])
    if spec != "gd" and spec != "lag-ps":      # a lazy worker in between
        assert m["comm_mask"].tolist() == [True, False, True]
    assert isinstance(theta, Parts) and theta.b.dtype == torch.bfloat16 \
        and theta.f.dtype == torch.float32
    laq = "laq" in spec
    grads, st, theta0, nabla0, _, _ = inputs

    def f32_ulp(g, w, what):
        if g.dtype == torch.bfloat16:
            bitwise(g, w, what)
        else:
            within(g, w, ulp(w, 24), what)

    def laq_f32(g, w, what):
        if g.dtype == torch.bfloat16:
            bitwise(g, w, what)
        else:
            within(g, w, LAQ_F32_REL * w.abs().max().double(), what)

    gh_rule = laq_f32 if laq else bitwise
    jgh = jls["grad_hat"]
    if laq and route == "on":      # one rounding on both planes
        jgh = run_reference(spec, srv, "on", inputs)[2]["grad_hat"]
    check_leaves("grad_hat", leaves_of(lo, ls["grad_hat"], True), jgh,
                 gh_rule)
    if "theta_hat" in ls:
        check_leaves("theta_hat", leaves_of(lo, ls["theta_hat"], True),
                     jls["theta_hat"], bitwise)
    if laq:
        check_leaves("resid", leaves_of(lo, ls["resid"], True), jls["resid"],
                     lambda g, w, what: within(g, w, RESID_ATOL, what))
    got_n, got_t = leaves_of(lo, ls["nabla"], False), \
        leaves_of(lo, theta, False)
    want_n = [to_t(x) for x in jax.tree_util.tree_leaves(jls["nabla"])]
    want_t = [to_t(x) for x in jax.tree_util.tree_leaves(jtheta)]
    pays = [to_t(g).double() - to_t(h).double() for g, h in zip(
        jax.tree_util.tree_leaves(grads),
        jax.tree_util.tree_leaves(st["grad_hat"]))]
    n0s = [to_t(x).double() for x in jax.tree_util.tree_leaves(nabla0)]
    alpha = lag.weak(0.1, torch.bfloat16)
    for i, (gn, gt, jn, jt, pay, n0) in enumerate(zip(
            got_n, got_t, want_n, want_t, pays, n0s)):
        what = f"leaf {i} ({gn.dtype})"
        if gn.dtype == torch.float32:
            if laq:        # the payloads of XLA's step (not IEEE)
                torch.testing.assert_close(gn, jn, rtol=F32_RTOL,
                                           atol=F32_RTOL)
            else:
                bitwise(gn, jn, "nabla " + what)
            # XLA's θ − α·∇ is one multiply-add: the product unrounded
            torch.testing.assert_close(gt, jt, rtol=F32_RTOL, atol=F32_RTOL)
            continue
        hulp = lambda x: ulp(x, 8) / 2
        jnd, jtd = jn.double(), jt.double()
        if spec == "gd":
            # XLA sums the unrounded payloads and rounds the sum; the port
            # rounds each payload, then their sum
            dn = hulp(pay).sum(0) + ulp(pay.sum(0), 8) + ulp(jnd, 8)
            within(gn, jnd, dn, "nabla " + what)
            within(gt, jtd, alpha * dn + ulp(alpha * jnd, 8) + ulp(jtd, 8),
                   "theta " + what)
        elif laq:
            # the reference's ∇ and θ are float32 (promoted by the payload)
            dn = hulp(jnd - n0) + hulp(jnd)
            within(gn, jnd, dn, "nabla " + what)
            within(gt, jtd, abs(alpha - 0.1) * jnd.abs() + alpha * dn
                   + hulp(alpha * jnd) + hulp(jtd) + 1e-6, "theta " + what)
        else:
            bitwise(gn, jn, "nabla " + what)
            bitwise(gt, jt, "theta " + what)
    rtol = ADAM_HIST_RTOL if srv == "adam" else HIST_RTOL
    if spec not in ("gd", "laq@4"):
        np.testing.assert_allclose(ls["hist"].numpy(), jls["hist"],
                                   rtol=rtol)


@pytest.mark.parametrize("route", ["on", "auto"])
@pytest.mark.parametrize("spec,srv", CASES)
def test_mixed_round_matches_reference(spec, srv, route):
    """The plane (``on``) and the plain route (``auto``) on a mixed tree
    against the reference's oracle round (module docstring)."""
    inputs = make_inputs(spec)
    ref = run_reference(spec, srv, "auto", inputs)
    check_round(spec, srv, route, inputs, ref,
                run_port(spec, srv, route, inputs))


@pytest.mark.parametrize("spec,srv", CASES)
def test_legacy_route_on_a_mixed_tree_matches_reference(spec, srv):
    """The legacy per-leaf route, each leaf at its own dtype, against the
    reference's ``use_pallas=True`` round (its Pallas kernels in interpret
    mode): the same bounds as its oracle route's."""
    inputs = make_inputs(spec)
    ref = run_reference(spec, srv, "legacy", inputs)
    check_round(spec, srv, "legacy", inputs, ref,
                run_port(spec, srv, "legacy", inputs))


@pytest.mark.parametrize("route", ["on", "auto", "legacy"])
@pytest.mark.parametrize("spec", ["lag-wk", "lag-ps", "laq@4"])
def test_bfloat16_grad_hat_on_a_mixed_tree(spec, route):
    """``grad_hat_dtype="bfloat16"``: ĝ bfloat16 on every leaf, the float32
    part's kernels the (f32, bf16) instantiations; on the legacy route the
    absmax and the encode take (f32, bf16, f32) operands.  Each route
    against the reference's same route: a float32 payload folds into a
    bfloat16 ĝ with one rounding on the planes, two on the other routes;
    masks equal, ĝ bitwise (the dense policies' bfloat16 leaves against
    the oracle route, LAQ within one bfloat16 ulp: XLA-CPU's encode is not
    IEEE)."""
    inputs = make_inputs(spec, ghdt=BF)
    ref = run_reference(spec, "sgd", route, inputs)
    # the dense bfloat16 leaves' ĝ: the oracle's (the reference's plane
    # adds the unrounded bfloat16 innovation, queue 3 (a))
    oracle = ref if route != "on" else run_reference(spec, "sgd", "auto",
                                                     inputs)
    lo, out = run_port(spec, "sgd", route, inputs, ghdt=torch.bfloat16)
    gh = out[2]["grad_hat"]
    assert gh.b.dtype == gh.f.dtype == torch.bfloat16
    np.testing.assert_array_equal(out[3]["comm_mask"].numpy(),
                                  ref[3]["comm_mask"])
    rule = bitwise
    if "laq" in spec:        # XLA-CPU's LAQ encode is not IEEE (queue 3)
        rule = lambda g, w, what: within(g, w, ulp(w, 8), what)
    for i, (g, w, o, dt) in enumerate(zip(
            leaves_of(lo, gh, True), jax.tree_util.tree_leaves(
                ref[2]["grad_hat"]), jax.tree_util.tree_leaves(
                oracle[2]["grad_hat"]), lo.dtypes)):
        dense_bf16 = dt == torch.bfloat16 and "laq" not in spec
        rule(g, to_t(o if dense_bf16 else w), f"grad_hat[{i}]")


# ---------------------------------------------------------------------------
# The legacy kernels' plain versions at the new operand combinations
# ---------------------------------------------------------------------------

def operand(shape, seed, dtype, scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


SHAPES = [(64,), (1000,), (257, 33)]
COMBOS = [("bfloat16", "bfloat16"), ("float32", "bfloat16")]


def j2d(*xs):
    return [jops._to_2d(x) for x in xs]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("combo", COMBOS, ids=["bb", "fb"])
def test_legacy_plain_versions_match_pallas_at_bf16_operands(shape, combo):
    (ja, ta), (jb, tb) = operand(shape, 0, combo[0]), \
        operand(shape, 1, combo[1], 0.5)
    np.testing.assert_allclose(
        float(ops.delta_sqnorm(ta, tb)),
        float(jkernels.delta_sqnorm_2d(*j2d(ja, jb), interpret=True)),
        rtol=SUM_RTOL)
    for mask in (0.0, 1.0):
        got = ops.masked_lazy_update(ta, tb, torch.tensor(mask))
        want = jops.masked_lazy_update(ja, jb, jnp.asarray(mask))
        assert got.dtype == tb.dtype
        bitwise(got, to_t(want), f"masked update m={mask}")
    (jg, tg), (jq, tq), (je, te) = operand(shape, 10, combo[0]), \
        operand(shape, 11, combo[1], 0.25), operand(shape, 12, "float32",
                                                    0.01)
    jscale = jkernels.innovation_absmax_2d(*j2d(jg, jq, je), interpret=True)
    bitwise(ref.innovation_absmax(tg, tq, te), to_t(jscale), "absmax")
    for bits in (2, 4, 8):
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
    if combo[0] == "bfloat16":
        np.testing.assert_allclose(
            float(ops.fused_tree_sqnorm(ta)),
            float(jkernels.sqnorm_2d(*j2d(ja), interpret=True)),
            rtol=SUM_RTOL)


def test_legacy_unbuilt_combinations_raise_on_the_cpu():
    """``ops`` refuses what ``lag_trigger.ENTRIES`` does not build, on the
    CPU as the kernel wrappers do on the card; ``use_ref`` (the oracle
    route, float64 included) takes anything."""
    f = torch.zeros(64)
    b, h, d = f.bfloat16(), f.half(), f.double()
    with pytest.raises(TypeError, match="no instantiation"):
        ops.delta_sqnorm(b, f)                         # (bf16, f32)
    with pytest.raises(TypeError, match="no instantiation"):
        ops.masked_lazy_update(b, f, torch.tensor(1.0))
    with pytest.raises(TypeError, match="no instantiation"):
        ops.fused_tree_sqnorm(d)                       # float64
    with pytest.raises(TypeError, match="no instantiation"):
        ops.delta_sqnorm(h, b)                         # (f16, bf16)
    with pytest.raises(TypeError, match="no instantiation"):
        ops.laq_encode(b, b, b)                        # a bf16 residual
    with pytest.raises(TypeError, match="no instantiation"):
        lag_trigger.laq_encode_2d(f, b, b, torch.ones(()), 4)
    ops.laq_encode(d, d, d, use_ref=True)
    assert set(lag_trigger.ENTRIES["laq_encode_2d"]) == {
        (torch.float32,) * 3, (torch.bfloat16, torch.bfloat16, torch.float32),
        (torch.float32, torch.bfloat16, torch.float32),
        (torch.float16, torch.float16, torch.float32),
        (torch.float32, torch.float16, torch.float32)}
    assert lag_trigger.LAUNCHES.keys() == {
        k + lag_trigger.SUFFIX[dts] for k, v in lag_trigger.ENTRIES.items()
        for dts in v}
    with pytest.raises(TypeError, match="no instantiation"):
        kernels.masked_combine(torch.zeros((W, 8, 128), dtype=torch.bfloat16),
                               torch.zeros((W, 8, 128)), torch.ones(W), "add")
