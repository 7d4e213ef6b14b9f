"""The slice as a whole: the port's trainer against the LIVE JAX reference.

Reduced llama3.2-1b, W = 2 workers, 3 steps of lag-wk, laq@4, lasg-wk
(its second backward pass at θ̂_m) and the schedules cyc-iag, num-iag,
cyc-laq@4 and num-lag-wk (the num- draws injected from the reference's
``jax.random.choice``; each round uploads exactly the scheduled worker): the
reference ``repro.dist.make_train_step`` (fastpath "on", interpret-mode
Pallas) and the port's ``make_train_step`` (fastpath "on", plain kernel
versions on the CPU) start from the same ``model.init`` parameters
exported to numpy and see the same ``TokenStream`` batches.  Losses agree
within rtol 1e-4, upload masks and counters are equal, parameters allclose
(rtol 1e-4, atol 1e-6) — for LAQ outside the few coordinates whose code
flips at a rounding boundary, a mechanism the test checks round by round
(:func:`check_laq_codes`).  The legacy per-leaf route
(``use_pallas_comm=True``: lag-wk, lag-ps, laq@4, lasg-wk) is held to the same
checks with losses within rtol 1e-5, and to the port's own batched plane.
The golden files are not used: they were recorded on another jax version.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import TokenStream as JTokenStream
from repro.data import make_inputs as jmake_inputs
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import make_train_step as jmake_train_step

from repro_torch.comm import SampledSchedule, ScheduledPolicy
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream, make_inputs
from repro_torch.fastpath.layout import SUB
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step, param_layout,
                                          params_of)
from repro_torch.launch import train as launch_train
from repro_torch.models import model
from repro_torch.weights import params_from_reference

BATCH, SEQ, STEPS, W = 4, 32, 3, 2
# LAQ code flips, measured on this setup (laq@4, lr 0.3): fresh flips sit
# within 1.1e-3 of a rounding boundary, codes differ by at most 3 after the
# residual carries a flip on, steps agree to 1.7e-4; after 3 rounds 909 of
# 1,312,000 parameters (639 of the embedding's 131,072) are off the dense
# tolerance, by at most 5.2e-3
BOUNDARY_TOL, MAX_CODE_DIFF, STEP_RTOL = 2e-3, 4, 5e-4
FLIP_SHARE, LEAF_FLIP_SHARE, MAX_DTHETA = 1e-3, 6e-3, 6e-3


def to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


def check_laq_codes(lo, mask, pay, jpay, jresid, touched, qmax):
    """One LAQ round, both sides as flat (W, rows·128) float64 arrays: the
    payloads (ĝ after − ĝ before) are whole codes × one step per (worker,
    leaf), the steps agree, and a coordinate whose code differs either sat
    on a rounding boundary of the reference's v/step (|resid/step| ≈ ½: a
    few-ulp gradient difference flips it) or had flipped in an earlier
    round (the residual carries the difference on).  ``touched`` (W, n)
    collects the flipped coordinates."""
    for m in np.flatnonzero(mask):
        for i, size in enumerate(lo.sizes):
            off = lo.leaf_sub_offsets[i] * SUB
            seg = slice(off, off + size)
            a, b = pay[m, seg], jpay[m, seg]
            sa, sb = np.abs(a).max() / qmax, np.abs(b).max() / qmax
            if sb == 0.0:
                assert sa == 0.0
                continue
            assert abs(sa - sb) <= STEP_RTOL * sb
            ca, cb = a / sa, b / sb
            assert np.abs(ca - np.round(ca)).max() <= 1e-5
            assert np.abs(cb - np.round(cb)).max() <= 1e-5
            flip = np.round(ca) != np.round(cb)
            assert np.abs(np.round(ca) - np.round(cb)).max() <= MAX_CODE_DIFF
            fresh = flip & ~touched[m, seg]
            assert np.all(np.abs(jresid[m, seg][fresh] / sb)
                          >= 0.5 - BOUNDARY_TOL)
            touched[m, seg] |= flip


@pytest.fixture(scope="module")
def cfgs():
    return jget_config("llama3.2-1b").reduced(), \
        get_config("llama3.2-1b").reduced()


@pytest.fixture(scope="module")
def ref_params(cfgs):
    jcfg, _ = cfgs
    st = jinit_state(jax.random.PRNGKey(0), jcfg,
                     JTrainerConfig(algo="gd", num_workers=W))
    return jax.tree_util.tree_map(np.asarray, st["params"])


def reference_draw(k):
    """The reference trainer's num- schedule draw at step k (schedule seed
    0), injected into the port's ``SampledSchedule``."""
    return int(jax.random.choice(jax.random.fold_in(
        jax.random.PRNGKey(0), k), W))


def port_policy(tcfg):
    """``tcfg``'s policy, a sampled schedule drawing the reference's
    workers (the port's own draw is not jax's)."""
    pol = tcfg.comm_policy()
    if not pol.needs_rng:
        return pol
    return ScheduledPolicy(pol.inner, SampledSchedule(draw=reference_draw))


def check_against_reference(cfgs, ref_params, algo, lr, xi, loss_rtol,
                            **route):
    """STEPS rounds of the reference and of the port on the same route
    (``route``: the TrainerConfig keywords both sides take), from the same
    weights and batches."""
    jcfg, cfg = cfgs
    jt = JTrainerConfig(algo=algo, num_workers=W, lr=lr, xi=xi, **route)
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    jstep = jax.jit(jmake_train_step(jcfg, jt))
    tcfg = TrainerConfig(algo=algo, num_workers=W, lr=lr, xi=xi, **route)
    policy = port_policy(tcfg)
    state = init_state(cfg, tcfg, device="cpu", policy=policy,
                       params=params_from_reference(
                           ref_params, cfg, device="cpu"))
    step = make_train_step(cfg, tcfg, policy=policy)
    jstream, stream = JTokenStream(jcfg.vocab_size), TokenStream(
        cfg.vocab_size)
    laq = "laq" in algo
    lo = param_layout(cfg)
    flat = lambda t: t.reshape(W, -1).double().numpy()
    touched = np.zeros((W, lo.rows * 128), bool)
    masks = []
    for k in range(STEPS):
        jb = jmake_inputs(jcfg, jstream, k, BATCH, SEQ)
        b = make_inputs(cfg, stream, k, BATCH, SEQ, device="cpu")
        np.testing.assert_array_equal(b["tokens"].numpy(), jb["tokens"])
        gh_before = state["lag"]["grad_hat"].clone()    # updated in place
        jgh_before = jstate["lag"]["grad_hat"]
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        if laq:
            jgh = lo.flatten_stacked(to_torch(jstate["lag"]["grad_hat"]))
            check_laq_codes(
                lo, m["comm_mask"].numpy(),
                flat(state["lag"]["grad_hat"] - gh_before),
                flat(jgh - lo.flatten_stacked(to_torch(jgh_before))),
                flat(lo.flatten_stacked(to_torch(jstate["lag"]["resid"]))),
                touched, qmax=7.0)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=loss_rtol)
        np.testing.assert_array_equal(m["comm_mask"].numpy(),
                                      np.asarray(jm["comm_mask"]))
        assert int(m["comm_this_round"]) == int(jm["comm_this_round"])
        masks.append(m["comm_mask"].tolist())
        if algo.startswith(("cyc-", "num-")):     # exactly the scheduled one
            want = k % W if algo.startswith("cyc-") else reference_draw(k)
            assert masks[-1] == [i == want for i in range(W)]
    np.testing.assert_array_equal(state["lag"]["comm_per_worker"].numpy(),
                                  np.asarray(jstate["lag"]["comm_per_worker"]))
    flips, n = 0, 0
    for a, b in zip(tree_leaves(params_of(state, cfg)),
                    jax.tree_util.tree_leaves(jstate["params"])):
        a, b = a.numpy(), np.asarray(b)
        if not laq:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
            continue
        # the flipped codes above move their coordinates by whole steps ·α;
        # everywhere else the dense tolerance holds
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
        assert off.sum() <= LEAF_FLIP_SHARE * a.size
        assert np.all(np.abs(a - b) <= MAX_DTHETA)
        flips, n = flips + int(off.sum()), n + a.size
    assert flips <= FLIP_SHARE * n
    if laq and not touched.any():
        assert flips == 0           # no code flipped: dense everywhere
    if xi == 10.0:      # the skip regime: lazy rounds happened
        assert masks[0] == [True, True] and not any(masks[1])


@pytest.mark.parametrize("algo,lr,xi", [("lag-wk", 0.3, 0.1),
                                        ("laq@4", 0.3, 0.1),
                                        ("lag-wk", 0.1, 10.0),
                                        ("lasg-wk", 0.3, 0.1),
                                        ("cyc-iag", 0.3, 0.1),
                                        ("num-iag", 0.3, 0.1),
                                        ("cyc-laq@4", 0.3, 0.1),
                                        ("num-lag-wk", 0.3, 0.1)])
def test_trainer_matches_live_reference(cfgs, ref_params, algo, lr, xi):
    check_against_reference(cfgs, ref_params, algo, lr, xi, 1e-4,
                            fastpath="on")


@pytest.mark.parametrize("algo", ["lag-wk", "lag-ps", "laq@4", "lasg-wk"])
def test_legacy_route_matches_live_reference(cfgs, ref_params, algo):
    """``use_pallas_comm=True`` on both sides: the reference's per-leaf
    Pallas kernels (interpret mode) against the port's per-leaf route (the
    kernels' plain versions on the CPU)."""
    check_against_reference(cfgs, ref_params, algo, 0.3, 0.1, 1e-5,
                            use_pallas_comm=True)


@pytest.mark.parametrize("algo", ["lag-wk", "lag-ps", "laq@4", "lasg-wk"])
def test_legacy_route_matches_the_forced_plane(cfgs, ref_params, algo):
    """The port's per-leaf route against its own batched plane (forced on),
    as the reference's ``test_trainer_pallas_comm_flag_parity``: the same
    uploads every round, losses within rtol 1e-5."""
    _, cfg = cfgs
    out = {}
    for route in ({"use_pallas_comm": True}, {"fastpath": "on"}):
        tcfg = TrainerConfig(algo=algo, num_workers=W, lr=0.3, **route)
        state = init_state(cfg, tcfg, device="cpu",
                           params=params_from_reference(
                               ref_params, cfg, device="cpu"))
        step = make_train_step(cfg, tcfg)
        stream = TokenStream(cfg.vocab_size)
        rounds = []
        for k in range(STEPS):
            state, m = step(state, make_inputs(cfg, stream, k, BATCH, SEQ,
                                               device="cpu"))
            rounds.append((float(m["loss"]), m["comm_mask"].tolist()))
        out[tuple(route)] = rounds
    legacy, plane = out[("use_pallas_comm",)], out[("fastpath",)]
    assert [c for _, c in legacy] == [c for _, c in plane]
    np.testing.assert_allclose([l for l, _ in legacy],
                               [l for l, _ in plane], rtol=1e-5)


def test_reference_params_keep_jax_leaf_order(cfgs, ref_params):
    _, cfg = cfgs
    port = params_from_reference(ref_params, cfg, device="cpu")
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    assert paths[:4] == ["['blocks']['0']['attn']['wk']",
                         "['blocks']['0']['attn']['wo']",
                         "['blocks']['0']['attn']['wq']",
                         "['blocks']['0']['attn']['wv']"]
    assert paths[-2:] == ["['embed']", "['final_norm']['scale']"]
    for a, (_, b) in zip(tree_leaves(port),
                         jax.tree_util.tree_flatten_with_path(ref_params)[0]):
        assert a.shape == b.shape and np.array_equal(a.numpy(), b)
    assert len(tree_leaves(port)) == 11
    # the stacked layer axis stays one leaf per weight
    assert port["blocks"]["0"]["mlp"]["w_gate"].shape[0] == cfg.num_layers


def test_full_width_layout_shape():
    """llama3.2-1b at full width: ≈1.236 B parameters, ≈9.66 M rows."""
    cfg = get_config("llama3.2-1b")
    lo = param_layout(cfg)
    n = sum(t.numel() for t in tree_leaves(model.templates(cfg)))
    assert 1.23e9 < n < 1.24e9 and lo.num_leaves == 11
    assert lo.rows * 128 >= n and 9.6e6 < lo.rows < 9.7e6
    assert 2 * lo.rows * 128 > 2 ** 31       # W = 2 needs 64-bit offsets


def test_port_init_is_seeded_and_finite(cfgs):
    _, cfg = cfgs
    tcfg = TrainerConfig(algo="lag-wk", num_workers=W)
    a = init_state(cfg, tcfg, device="cpu", seed=3)["theta"]
    b = init_state(cfg, tcfg, device="cpu", seed=3)["theta"]
    assert torch.equal(a, b) and torch.isfinite(a).all()
    leaves = tree_leaves(params_of({"theta": a}, cfg))
    assert float(leaves[-1].min()) == 1.0            # final_norm scale


def test_cli_needs_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_train.main(["--reduced", "--steps", "1", "--workers", "2",
                           "--batch", "2", "--seq", "8"])
    state = launch_train.main(["--reduced", "--steps", "1", "--workers",
                               "2", "--batch", "2", "--seq", "8",
                               "--device", "cpu"])
    assert int(state["lag"]["comm_total"]) == 2
