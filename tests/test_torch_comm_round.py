"""One LAG round per policy: the port's ``policy_rounds`` (fast route with
the plane forced on, and the plain per-leaf route that "auto" takes on the
CPU) against the JAX
reference's ``policy_rounds`` with ``fastpath="on"``, on the same numpy
inputs.  Masks must be identical, deltas and state allclose, and the
server invariant Σ_m ĝ_m = ∇ must hold after the round.

The inputs put each worker's trigger LHS far from the RHS (worker 1 close
to its mirror, the others far), so a decision never rests on a last-bit
difference between the two packages' sum orders.
"""
import jax
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import lag as jlag
from repro.engine import rounds as jrounds

from repro_torch import comm
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves
from repro_torch.engine import rounds
from repro_torch.fastpath.layout import BLOCK, FlatLayout
from repro_torch.fastpath.plan import FastPathPlan

W = 3
SIZES = (1, 127, 129, BLOCK, 0, 3000)
RTOL, ATOL = 1e-6, 1e-7
# LAQ's residual v − codes·step: XLA-CPU fuses it into a multiply-add, the
# port does not — ≤ 1 ulp of |v| (|v| < 4 here), see test_torch_layout_plan
STATE_ATOL = 5e-7


def np_tree(lead=(), seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda s: (scale * rng.standard_normal(lead + (s,))).astype(
        np.float32)
    return {"w": mk(SIZES[0]), "a": {"k": mk(SIZES[1]), "b": mk(SIZES[2])},
            "blk": [mk(SIZES[3]), mk(SIZES[4])], "c": mk(SIZES[5])}


def near(tree, seed, s=(1.0, 0.01, 1.0)):
    """``tree`` minus per-worker noise of size s_m."""
    noise = np_tree((W,), seed)
    return jax.tree_util.tree_map(
        lambda x, n: (x - np.asarray(s, np.float32).reshape(
            (W,) + (1,) * (x.ndim - 1)) * n).astype(np.float32), tree, noise)


def to_t(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


def make_inputs(spec):
    """(grads, state, theta, hist, grad_at_hat): LASG-WK's trigger reads
    ∇ℓ_m(θ̂_m), near the fresh gradient for worker 1 only; ``spec`` may
    carry a schedule prefix."""
    grads = np_tree((W,), 1)
    state = {"grad_hat": near(grads, 2)}
    theta = np_tree((), 3)
    if spec in ("lag-ps", "lasg-wk"):
        state["theta_hat"] = near(jax.tree_util.tree_map(
            lambda x: np.broadcast_to(x, (W,) + x.shape), theta), 4,
            s=(0.05, 0.0005, 0.05))
    if "laq" in spec:
        state["resid"] = np_tree((W,), 5, scale=0.01)
    gah = near(grads, 6) if spec == "lasg-wk" else None
    lhs = [sum(float(np.sum((a[m] - b[m]) ** 2)) for a, b in zip(
        jax.tree_util.tree_leaves(grads),
        jax.tree_util.tree_leaves(state["grad_hat"] if gah is None
                                  else gah))) for m in range(W)]
    hist = np.full((4,), 0.03 * max(lhs) * 0.01 * W * W / (0.25 * 4),
                   np.float32)
    if spec == "lag-ps":
        hist = hist * np.float32(1e-2)
    return grads, state, theta, hist, gah


def reference_draw(k):
    """The reference's num- schedule draw for round k (schedule seed 0),
    injected into the port's ``SampledSchedule``."""
    return int(jax.random.choice(jax.random.fold_in(
        jax.random.PRNGKey(0), k), W))


def with_reference_draws(pol):
    """``pol`` with a sampled schedule's draw replaced by the reference's."""
    if not pol.needs_rng:
        return pol
    return comm.ScheduledPolicy(pol.inner,
                                comm.SampledSchedule(draw=reference_draw))


SPECS = ["gd", "lag-wk", "lag-ps", "laq@4", "lasg-wk", "cyc-iag", "num-iag",
         "cyc-laq@4", "num-lag-wk"]


@pytest.mark.parametrize("port_mode", ["on", "auto"])
@pytest.mark.parametrize("spec", SPECS)
def test_one_round_matches_reference(spec, port_mode):
    """Round K = 5; the sampled schedules see the reference's draw.  The
    port's ``grad_at_hat`` is the stacked buffer on the plane and W rows
    on the plain route; either way the round empties the list."""
    K = 5
    grads, state, theta, hist, gah = make_inputs(spec)
    L_m = np.full((W,), 10.0, np.float32)
    jcfg = jlag.LAGConfig(num_workers=W, alpha=0.1, D=4, xi=0.25,
                          rule="ps" if spec == "lag-ps" else "wk")
    cfg = lag.LAGConfig(num_workers=W, alpha=0.1, D=4, xi=0.25,
                        rule=jcfg.rule)
    jpol = jcomm.make_policy(spec, fastpath="on")
    jstate = dict(state, hist=hist, L_m=L_m)
    jc, jd, jst = jrounds.policy_rounds(
        jpol, jcfg, theta, grads, jstate, gah, step=K,
        key=jax.random.fold_in(jax.random.PRNGKey(0), K))

    pol = with_reference_draws(comm.make_policy(spec, fastpath=port_mode))
    lo = FlatLayout.for_tree(to_t(theta))
    pstate = {k: lo.flatten_stacked(to_t(v)) for k, v in state.items()}
    pstate.update(hist=torch.from_numpy(hist), L_m=torch.from_numpy(L_m))
    gh_before = pstate["grad_hat"].clone()
    holder = None
    if gah is not None:
        stacked = lo.flatten_stacked(to_t(gah))
        holder = [stacked] if port_mode == "on" else list(stacked.clone())
    draw = pol.draw(K, W) if pol.needs_rng else None
    c, d, st = rounds.policy_rounds(pol, cfg, lo.flatten(to_t(theta)),
                                    lo.flatten_stacked(to_t(grads)), pstate,
                                    lo, grad_at_hat=holder, step=K, draw=draw)

    assert c.dtype == torch.bool and c.shape == (W,)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    if spec != "gd":
        assert 0 < int(c.sum()) < W, "inputs should give a mixed mask"
    if spec.startswith(("cyc-", "num-")):
        want = K % W if spec.startswith("cyc-") else reference_draw(K)
        assert c.tolist() == [m == want for m in range(W)]
    assert holder in (None, [])
    for a, b in zip(tree_leaves(lo.unflatten_stacked(d)),
                    jax.tree_util.tree_leaves(jd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    for k in pol.state_keys:
        for a, b in zip(tree_leaves(lo.unflatten_stacked(st[k])),
                        jax.tree_util.tree_leaves(jst[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=STATE_ATOL)
    # Σ_m ĝ_m advances by exactly the summed delta (∇^k = Σ_m ĝ_m)
    torch.testing.assert_close(st["grad_hat"].sum(0),
                               gh_before.sum(0) + rounds.sum_reduce(c, d),
                               rtol=1e-6, atol=1e-6)


def test_fast_route_updates_state_in_place():
    grads, state, theta, hist, _ = make_inputs("laq@4")
    pol = comm.make_policy("laq@4", fastpath="on")
    lo = FlatLayout.for_tree(to_t(theta))
    pstate = {k: lo.flatten_stacked(to_t(v)) for k, v in state.items()}
    pstate["hist"] = torch.from_numpy(hist)
    g = lo.flatten_stacked(to_t(grads))
    ptrs = {k: v.data_ptr() for k, v in pstate.items()}
    cfg = lag.LAGConfig(num_workers=W, alpha=0.1, D=4, xi=0.25)
    _, d, st = rounds.policy_rounds(pol, cfg, lo.flatten(to_t(theta)), g,
                                    pstate, lo)
    assert d.data_ptr() == g.data_ptr()          # payload over the grads
    assert all(st[k].data_ptr() == ptrs[k] for k in pol.state_keys)


def test_make_policy_grammar():
    assert comm.make_policy("laq@8").bits == 8
    assert comm.make_policy("lag-wk").fastpath.mode == "auto"
    with pytest.raises(ValueError, match="fastpath mode"):
        comm.make_policy("lag-wk", fastpath="off")    # there is no "off"
    # None is no plan (the plain route), chosen explicitly
    assert comm.make_policy("lag-wk", fastpath=None).fastpath is None
    for good in ("lasg-wk", "cyc-iag", "num-iag", "cyc-laq@8", "lag-adam"):
        comm.make_policy(good)
    for bad in ("iag", "rand-iag", "lag-wk@4", "laq@x", "", "sgd"):
        with pytest.raises(ValueError):
            comm.make_policy(bad)


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_active_plan_refuses_a_layout_it_cannot_serve(mode, monkeypatch):
    """A float64 tree under an active plan raises; it never falls back to
    the plain route.  "auto" is made active as on CUDA tensors."""
    if mode == "auto":
        monkeypatch.setattr(FastPathPlan, "enabled_for", lambda self, x: True)
    tree = {"w": torch.zeros(300, dtype=torch.float64),
            "b": torch.zeros(7, dtype=torch.float64)}
    lo = FlatLayout.for_tree(tree)
    pol = comm.make_policy("lag-wk", fastpath=mode)
    cfg = lag.LAGConfig(num_workers=2, alpha=0.1, D=4, xi=0.25)
    st = {"grad_hat": lo.empty((2,)), "hist": lag.hist_init(4, "cpu")}
    with pytest.raises(ValueError, match="cannot serve"):
        rounds.policy_rounds(pol, cfg, lo.empty(), lo.empty((2,)), st, lo)


def test_base_fast_precompute_is_the_tripwire():
    class Sneaky(comm.CommPolicy):
        def should_upload(self, ctx, st, payload, aux):
            return torch.ones((), dtype=torch.bool)

    with pytest.raises(NotImplementedError, match="fast-path route"):
        Sneaky(fastpath="on").fast_precompute(None, None, {}, theta=None,
                                              layout=None)


def test_trigger_rhs_and_hist_match_reference():
    rng = np.random.default_rng(0)
    for D in (1, 4, 10):
        hist = (rng.random(D) * 10.0 ** rng.uniform(-6, 2, D)).astype(
            np.float32)
        jc = jlag.LAGConfig(num_workers=3, alpha=0.05, D=D, xi=0.1,
                            rhs_floor=1e-12)
        c = lag.LAGConfig(num_workers=3, alpha=0.05, D=D, xi=0.1,
                          rhs_floor=1e-12)
        new = np.float32(rng.random())
        assert np.asarray(jlag.hist_push(hist, new)).tobytes() == \
            lag.hist_push(torch.from_numpy(hist),
                          torch.tensor(new)).numpy().tobytes()
        # XLA-CPU's dot uses fused multiply-adds in a length-dependent
        # order: agreement to 1 ulp, not bit for bit
        np.testing.assert_allclose(
            lag.trigger_rhs(torch.from_numpy(hist), c).numpy(),
            np.asarray(jlag.trigger_rhs(hist, jc)), rtol=2.5e-7)
        assert bool(lag.rhs_underflow(torch.zeros(D), c, 3)) \
            == bool(jlag.rhs_underflow(np.zeros(D, np.float32), jc, 3))
