"""bfloat16 training: the port's round and trainer against the LIVE JAX
reference with bfloat16 trees.

The round alone (W = 3, the plain-version plane ``fastpath="on"`` and the
plain per-leaf route ``"auto"``): bfloat16 gradients, mirrors and θ from
numpy seeds go through the port's ``engine.rounds.lag_round`` and the
reference's, jitted, with the trigger LHS far from the RHS for every
worker.  The per-sub-block trigger partials on bfloat16 operands equal
the float32 partials on the widened operands bit for bit (and the
reference's Pallas kernel's within the float32 sum-order tolerance).  Where the
two packages do the same arithmetic, masks, ĝ, θ̂, ∇, θ and the history
are equal bit for bit to the reference's oracle route (its CPU default).
Where XLA-CPU computes something else (ROADMAP queue 3, "bfloat16
training"), the test holds the stated bound:

- the reference's plane adds the unrounded bfloat16 payload into ĝ (XLA
  drops the bfloat16 round trip of ``g − ĝ`` inside its fused flatten):
  within one bfloat16 ulp of ĝ;
- gd's constant mask lets XLA sum the unrounded payloads (the sum rounded
  once): ∇ and θ within the payloads' and the sum's roundings;
- LAQ's float32 payload promotes the reference's ∇ and θ to float32 in
  round 0 (its train step then fails in round 1): the port keeps them in
  bfloat16, within one bfloat16 ulp of the reference's float32 values;
- Adam's iterate-lag entry reads the unrounded float32 step in the
  reference, the bfloat16 movement in the port: within 2⁻⁷ relative.

Then the trainer: reduced bfloat16 llama3.2-1b, W = 2, 3 rounds of
lag-wk, lag-ps, lag-adam (one round of laq@4: the reference's second
fails) and the float32 model with ``grad_hat_dtype="bfloat16"`` against the
reference's jitted ``make_train_step`` from the same weights and batches:
masks equal, bfloat16 losses within 2× the reference's own bfloat16 error
against its float32 run on the widened weights (the largest over the
rounds, as ``test_torch_bf16.py`` holds serving), float32 losses within
rtol 1e-4.  The state's buffers are
bfloat16 views at half the float32 bytes; a tree that mixes bfloat16 and
float32 leaves initialises into two parts and takes a step; of the training
paths only the gossip graph refuses bfloat16, by name.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.configs import get_config as jget_config
from repro.core import lag as jlag
from repro.data import TokenStream as JTokenStream
from repro.data import make_inputs as jmake_inputs
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import make_train_step as jmake_train_step
from repro.engine import rounds as jrounds
from repro.engine import server as jserver
from repro.fastpath import kernels as jk
from repro.fastpath.layout import FlatLayout as JFlatLayout

from repro_torch import comm
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist import lag_trainer
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step, param_layout,
                                          params_of)
from repro_torch.engine import rounds, server
from repro_torch.engine.topology import make_topology
from repro_torch.fastpath import kernels
from repro_torch.fastpath.layout import BLOCK, SUB, FlatLayout
from repro_torch.models import model
from repro_torch.weights import params_from_reference

BF = ml_dtypes.bfloat16
W = 3
SIZES = (1, 127, 129, BLOCK, 3000)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
#: the port's bfloat16 loss error against the reference's float32 run, as
#: a multiple of the reference's own bfloat16 error (test_torch_bf16.py)
ERR_RATIO = 2.0
#: Adam's iterate-lag entry: the reference's unrounded float32 step against
#: the port's bfloat16 movement (one bfloat16 rounding of each coordinate)
ADAM_HIST_RTOL = 2.0 ** -7


# ---------------------------------------------------------------------------
# Inputs and comparisons
# ---------------------------------------------------------------------------

def np_tree(lead=(), seed=0, scale=1.0, dt=BF):
    rng = np.random.default_rng(seed)
    mk = lambda s: (scale * rng.standard_normal(lead + (s,))).astype(
        np.float32).astype(dt)
    return {"w": mk(SIZES[0]), "a": {"k": mk(SIZES[1]), "b": mk(SIZES[2])},
            "blk": [mk(SIZES[3])], "c": mk(SIZES[4])}


def near(tree, seed, s, dt):
    """``tree`` minus per-worker noise of size s_m, at ``dt``."""
    noise = np_tree((W,), seed, dt=np.float32)
    return jax.tree_util.tree_map(
        lambda x, n: (x.astype(np.float32) - np.asarray(s, np.float32)
                      .reshape((W,) + (1,) * (n.ndim - 1)) * n).astype(dt),
        tree, noise)


def to_t(a) -> torch.Tensor:
    """A numpy / jax array as a tensor, bfloat16 bit for bit."""
    a = np.array(a)
    if a.dtype == BF:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tt(tree):
    return jax.tree_util.tree_map(to_t, tree)


def make_round_inputs(spec, pdt=BF, ghdt=BF):
    """(grads, state, θ, ∇, hist, ∇ℓ(θ̂)): worker 1 close to its mirror,
    the others far, every LHS far from the RHS."""
    grads = np_tree((W,), 1, dt=pdt)
    st = {"grad_hat": near(grads, 2, (1.0, 0.01, 1.0), ghdt)}
    theta = np_tree((), 3, dt=pdt)
    if spec in ("lag-ps", "lasg-wk"):
        st["theta_hat"] = near(jax.tree_util.tree_map(
            lambda t: np.broadcast_to(t, (W,) + t.shape), theta), 4,
            (0.05, 0.0005, 0.05), pdt)
    if "laq" in spec:
        st["resid"] = np_tree((W,), 5, scale=0.01, dt=np.float32)
    gah = near(grads, 6, (1.0, 0.01, 1.0), pdt) if spec == "lasg-wk" \
        else None
    nabla = jax.tree_util.tree_map(
        lambda x: np.sum(x.astype(np.float32), 0).astype(pdt),
        st["grad_hat"])
    hist = np.full((4,), 0.03 if spec == "lag-ps" else 3.0, np.float32)
    return grads, st, theta, nabla, hist, gah


def flat(lo, tree, stacked, dtype):
    """A reference tree as the port's flat buffer of ``dtype``."""
    buf = lo.empty((W,) if stacked else (), dtype=dtype)
    view = buf.view(W, -1) if stacked else buf.view(1, -1)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        off = lo.leaf_sub_offsets[i] * SUB
        view[:, off:off + lo.sizes[i]].copy_(
            to_t(leaf).reshape(view.shape[0], -1))
    return buf


def ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.double().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8)


def within_ulp(got: torch.Tensor, want: torch.Tensor, what: str):
    d = (got.double() - want.double()).abs()
    assert torch.all(d <= ulp(want)), (what, float(d.max()))


def bitwise(got: torch.Tensor, want: torch.Tensor, what: str):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert torch.equal(got, want), (what, float(
        (got.double() - want.double()).abs().max()))


def run_reference(spec, srv, jmode, inputs):
    grads, st, theta, nabla, hist, gah = inputs
    jcfg = jlag.LAGConfig(num_workers=W, alpha=0.1, D=4, xi=0.25,
                          rule="ps" if spec == "lag-ps" else "wk")
    jpol = jcomm.make_policy(spec, fastpath=jmode)
    jsrv = jserver.make_server(srv)
    jls = dict(st, nabla=nabla, hist=hist,
               L_m=np.full((W,), 10.0, np.float32),
               comm_total=np.int32(0), comm_per_worker=np.zeros(W, np.int32))
    params = jax.tree_util.tree_map(jnp.asarray, theta)
    out = jax.jit(lambda p, o, ls, g, gh: jrounds.lag_round(
        jpol, jsrv, jcfg, params=p, opt_state=o, lag_state=ls, grads=g,
        step=jnp.int32(5), grad_at_hat=gh))(params, jsrv.init(params), jls,
                                            grads, gah)
    return jax.tree_util.tree_map(np.asarray, out)


def run_port(spec, srv, mode, inputs, pdt=torch.bfloat16,
             ghdt=torch.bfloat16):
    grads, st, theta, nabla, hist, gah = inputs
    lo = FlatLayout.for_tree(tt(theta))
    assert lo.dtype == pdt
    cfg = lag.LAGConfig(num_workers=W, alpha=0.1, D=4, xi=0.25,
                        rule="ps" if spec == "lag-ps" else "wk")
    ls = {"grad_hat": flat(lo, st["grad_hat"], True, ghdt)}
    if "theta_hat" in st:
        ls["theta_hat"] = flat(lo, st["theta_hat"], True, pdt)
    if "resid" in st:
        ls["resid"] = flat(lo, st["resid"], True, torch.float32)
    ls.update(nabla=flat(lo, nabla, False, pdt), hist=torch.from_numpy(hist),
              L_m=torch.full((W,), 10.0), comm_total=torch.zeros(
                  (), dtype=torch.int32),
              comm_per_worker=torch.zeros(W, dtype=torch.int32))
    gl = None
    if gah is not None:
        gb = flat(lo, gah, True, pdt)
        gl = [gb] if mode == "on" else list(gb.unbind(0))
    sv = server.make_server(srv)
    theta_b = flat(lo, theta, False, pdt)
    out = rounds.lag_round(comm.make_policy(spec, fastpath=mode), sv, cfg,
                           theta=theta_b, layout=lo,
                           opt_state=sv.init(theta_b), lag_state=ls,
                           grads=flat(lo, grads, True, pdt), step=5,
                           grad_at_hat=gl)
    return lo, out


# ---------------------------------------------------------------------------
# The round alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["lag-wk", "lag-ps", "lasg-wk"])
def test_trigger_partials_on_bf16_operands(spec):
    """The plane's per-sub-block LHS partials on bfloat16 operands (the
    kernels' plain versions) equal the float32 partials on the widened
    buffers bit for bit, and the reference's Pallas kernel's within the
    float32 sum-order tolerance (``test_torch_layout_plan.SUM_RTOL``)."""
    grads, st, theta, _, _, gah = make_round_inputs(spec)
    a, b = {"lag-wk": (grads, st["grad_hat"]),
            "lag-ps": (st.get("theta_hat"), None),
            "lasg-wk": (grads, gah)}[spec]
    jlo = JFlatLayout.for_tree(theta)
    lo = FlatLayout.for_tree(tt(theta))
    ta = flat(lo, a, True, torch.bfloat16)
    if b is None:                        # θ̂ against the shared θ
        want = jk.delta_sqnorm_blocks(jlo.flatten_stacked(a),
                                      jlo.flatten(theta))
        tb = flat(lo, theta, False, torch.bfloat16)
    else:
        want = jk.delta_sqnorm_blocks(jlo.flatten_stacked(a),
                                      jlo.flatten_stacked(b))
        tb = flat(lo, b, True, torch.bfloat16)
    got = kernels.delta_sqnorm_blocks(ta, tb)
    bitwise(got, kernels.delta_sqnorm_blocks(ta.float(), tb.float()),
            "partials vs float32")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=0)


def within(got: torch.Tensor, want: torch.Tensor, bound: torch.Tensor,
           what: str):
    d = (got.double() - want.double()).abs()
    assert torch.all(d <= bound), (what, float((d - bound).max()))


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("spec,srv", [
    ("lag-wk", "sgd"), ("lag-ps", "sgd"), ("lasg-wk", "sgd"),
    ("lag-wk", "momentum@0.9"), ("lag-wk", "prox-l1@0.5"),
    ("lag-wk", "adam"), ("gd", "sgd"), ("laq@4", "sgd")])
def test_bf16_round_matches_reference(spec, srv, mode):
    """One round at bfloat16 against the reference's oracle route (and,
    for ĝ, its plane): bitwise where the arithmetic is the same, within
    the queue-3 bounds (module docstring) where XLA's is not."""
    inputs = make_round_inputs(spec)
    ref = run_reference(spec, srv, "auto", inputs)
    lo, (theta, _, ls, m) = run_port(spec, srv, mode, inputs)
    jtheta, _, jls, jm = ref
    np.testing.assert_array_equal(m["comm_mask"].numpy(), jm["comm_mask"])
    if spec in ("lag-wk", "lasg-wk", "laq@4"):   # a lazy worker in between
        assert m["comm_mask"].tolist() == [True, False, True]
    assert theta.dtype == ls["nabla"].dtype == ls["grad_hat"].dtype \
        == torch.bfloat16
    bf, f32 = torch.bfloat16, torch.float32
    laq = "laq" in spec
    grads, st, theta0, nabla0, _, _ = inputs
    # the round's candidate payload g − ĝ (exact in float64), for bounds
    pay = flat(lo, grads, True, f32).double() \
        - flat(lo, st["grad_hat"], True, f32).double()
    hulp = lambda x: ulp(x) / 2
    # ĝ: the reference's plane and oracle differ for the dense family (its
    # plane adds the unrounded payload, so an uploader's ĝ becomes ≈ g); LAQ's
    # float32 payload rounds once on both planes, twice on both oracles
    jgh = flat(lo, jls["grad_hat"], True, bf)
    if laq and mode == "on":
        jgh = flat(lo, run_reference(spec, srv, "on", inputs)[2]["grad_hat"],
                   True, bf)
    bitwise(ls["grad_hat"], jgh, "grad_hat")
    if not laq and mode == "on":
        jplane = flat(lo, run_reference(spec, srv, "on", inputs)[2]
                      ["grad_hat"], True, bf)
        within(ls["grad_hat"], jplane, hulp(pay) + hulp(jplane),
               "grad_hat vs the reference's plane")
    if "theta_hat" in ls:
        bitwise(ls["theta_hat"], flat(lo, jls["theta_hat"], True, bf),
                "theta_hat")
    if laq:
        # the reference's residual: XLA-CPU's fused encode (≤ 1 ulp of |v|,
        # test_torch_comm_round.STATE_ATOL)
        np.testing.assert_allclose(
            ls["resid"].numpy(),
            flat(lo, jls["resid"], True, f32).numpy(), atol=5e-7)
    jn = flat(lo, jls["nabla"], False, f32).double()
    jt = flat(lo, jtheta, False, f32).double()
    alpha = lag.weak(0.1, bf)
    if spec == "gd":
        # XLA sums the unrounded payloads and rounds the sum; the port
        # rounds each payload, then their sum
        dn = hulp(pay).sum(0) + ulp(pay.sum(0)) + ulp(jn)
        within(ls["nabla"], jn, dn, "nabla")
        within(theta, jt, alpha * dn + ulp(alpha * jn) + ulp(jt), "theta")
    elif laq:
        # the reference's ∇ and θ are float32 (promoted by the payload)
        n0 = flat(lo, nabla0, False, f32).double()
        dn = hulp(jn - n0) + hulp(jn)
        within(ls["nabla"], jn, dn, "nabla")
        within(theta, jt, abs(alpha - 0.1) * jn.abs() + alpha * dn
               + hulp(alpha * jn) + hulp(jt) + 1e-6, "theta")
    else:
        bitwise(ls["nabla"], jn.to(bf), "nabla")
        bitwise(theta, jt.to(bf), "theta")
    if srv == "adam":
        np.testing.assert_allclose(ls["hist"].numpy(), jls["hist"],
                                   rtol=ADAM_HIST_RTOL)
    elif spec not in ("gd", "laq@4"):
        bitwise(ls["hist"], torch.from_numpy(jls["hist"]), "hist")


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("spec", ["lag-wk", "lag-ps", "laq@4"])
def test_bfloat16_grad_hat_on_a_float32_model(spec, mode):
    """``grad_hat_dtype="bfloat16"`` on float32 trees: the plane's ĝ is the
    float32 fold rounded once (the ``_fb`` instantiations), bitwise the
    reference's plane; the plain route rounds the delta first, bitwise the
    reference's oracle.  ∇ and θ stay float32 (θ within the float32 trainer
    tests' tolerance: XLA fuses α·∇ into a multiply-add)."""
    inputs = make_round_inputs(spec, pdt=np.float32, ghdt=BF)
    jtheta, _, jls, jm = run_reference(spec, "sgd", mode, inputs)
    lo, (theta, _, ls, m) = run_port(spec, "sgd", mode, inputs,
                                     pdt=torch.float32)
    np.testing.assert_array_equal(m["comm_mask"].numpy(), jm["comm_mask"])
    assert ls["grad_hat"].dtype == torch.bfloat16
    assert ls["nabla"].dtype == theta.dtype == torch.float32
    jgh = flat(lo, jls["grad_hat"], True, torch.bfloat16)
    if "laq" in spec:      # XLA-CPU's LAQ encode is not IEEE (queue 3)
        within_ulp(ls["grad_hat"], jgh, "grad_hat")
    else:
        bitwise(ls["grad_hat"], jgh, "grad_hat")
    np.testing.assert_allclose(
        theta.numpy(), flat(lo, jtheta, False, torch.float32).numpy(),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The trainer on a reduced bfloat16 llama
# ---------------------------------------------------------------------------

BATCH, SEQ, STEPS, TW = 4, 16, 3, 2


@pytest.fixture(scope="module")
def bf16_weights():
    """The reference's bfloat16 init (its ``init_state``), as numpy."""
    jcfg = jget_config("llama3.2-1b").reduced(**BF16)
    st = jinit_state(jax.random.PRNGKey(0), jcfg,
                     JTrainerConfig(algo="gd", num_workers=TW))
    return jax.tree_util.tree_map(np.asarray, st["params"])


def reference_run(jcfg, jt, params, steps):
    state = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    state["params"] = jax.tree_util.tree_map(jnp.asarray, params)
    step = jax.jit(jmake_train_step(jcfg, jt))
    stream = JTokenStream(jcfg.vocab_size)
    losses, masks = [], []
    for k in range(steps):
        state, m = step(state, jmake_inputs(jcfg, stream, k, BATCH, SEQ))
        losses.append(float(m["loss"]))
        masks.append(np.asarray(m["comm_mask"]).tolist())
    return losses, masks


def port_run(cfg, tcfg, params, steps):
    state = init_state(cfg, tcfg, device="cpu",
                       params=params_from_reference(params, cfg,
                                                    device="cpu"))
    step = make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size)
    losses, masks = [], []
    for k in range(steps):
        state, m = step(state, make_inputs(cfg, stream, k, BATCH, SEQ,
                                           device="cpu"))
        losses.append(float(m["loss"]))
        masks.append(m["comm_mask"].tolist())
    return state, losses, masks


@pytest.mark.parametrize("algo,steps", [("lag-wk", STEPS), ("lag-ps", STEPS),
                                        ("lag-adam", STEPS), ("laq@4", 1)])
def test_bf16_trainer_matches_live_reference(bf16_weights, algo, steps):
    """3 rounds (laq@4: 1, the reference's last) on the plane: masks equal,
    losses within 2× the reference's own bfloat16 error against its float32
    run on the widened weights (the largest over the rounds, as
    ``test_torch_bf16.within_ratio`` takes the largest over the logits: a
    round where the reference's error happens to be small is no scale);
    θ, ∇ and ĝ stay bfloat16 views."""
    kw = dict(algo=algo, num_workers=TW, lr=0.3)
    jcfg = jget_config("llama3.2-1b").reduced(**BF16)
    ref_bf, ref_masks = reference_run(jcfg, JTrainerConfig(**kw),
                                      bf16_weights, steps)
    wide = jax.tree_util.tree_map(lambda x: x.astype(np.float32),
                                  bf16_weights)
    ref_32, _ = reference_run(jget_config("llama3.2-1b").reduced(),
                              JTrainerConfig(**kw), wide, steps)
    cfg = get_config("llama3.2-1b").reduced(**BF16)
    state, losses, masks = port_run(cfg, TrainerConfig(**kw, fastpath="on"),
                                    bf16_weights, steps)
    assert masks == ref_masks
    assert np.all(np.isfinite(losses))
    got = np.max(np.abs(np.subtract(losses, ref_32)))
    own = np.max(np.abs(np.subtract(ref_bf, ref_32)))
    assert got <= ERR_RATIO * own, (losses, ref_bf, ref_32)
    theta = state["theta"]
    assert theta.dtype == torch.bfloat16
    assert all(l.dtype == torch.bfloat16 and l.untyped_storage().data_ptr()
               == theta.untyped_storage().data_ptr()
               for l in tree_leaves(params_of(state, cfg)))
    for k in ("grad_hat", "nabla", "theta_hat"):
        if k in state["lag"]:
            assert state["lag"][k].dtype == torch.bfloat16, k
    if "laq" in algo:
        assert state["lag"]["resid"].dtype == torch.float32


def test_float32_model_with_bf16_grad_hat_matches_live_reference():
    """``grad_hat_dtype="bfloat16"`` on the float32 model, 3 rounds of
    lag-wk on the plain route (the reference's oracle arithmetic): masks
    equal, losses within the float32 trainer tests' rtol 1e-4."""
    kw = dict(algo="lag-wk", num_workers=TW, lr=0.3,
              grad_hat_dtype="bfloat16")
    jcfg = jget_config("llama3.2-1b").reduced()
    st = jinit_state(jax.random.PRNGKey(0), jcfg, JTrainerConfig(**kw))
    params = jax.tree_util.tree_map(np.asarray, st["params"])
    ref, ref_masks = reference_run(jcfg, JTrainerConfig(**kw), params,
                                   STEPS)
    cfg = get_config("llama3.2-1b").reduced()
    for mode in ("auto", "on"):
        state, losses, masks = port_run(
            cfg, TrainerConfig(**kw, fastpath=mode), params, STEPS)
        assert masks == ref_masks
        np.testing.assert_allclose(losses, ref, rtol=1e-4)
        assert state["lag"]["grad_hat"].dtype == torch.bfloat16
        assert state["theta"].dtype == state["lag"]["nabla"].dtype \
            == torch.float32


def test_bf16_state_is_half_the_float32_bytes():
    """θ, ∇ and the mirrors of a bfloat16 config take half the bytes of
    the float32 config's; the plane and the plain route agree bitwise."""
    kw = dict(algo="lag-ps", num_workers=TW, lr=0.3)
    nbytes = lambda st: {k: st["lag"][k].nbytes for k in
                         ("grad_hat", "theta_hat", "nabla")} | {
                             "theta": st["theta"].nbytes}
    cfg = get_config("llama3.2-1b").reduced()
    s32 = init_state(cfg, TrainerConfig(**kw), device="cpu")
    s16 = init_state(cfg.replace(**BF16), TrainerConfig(**kw), device="cpu")
    assert {k: 2 * v for k, v in nbytes(s16).items()} == nbytes(s32)
    cfg16 = cfg.replace(**BF16)
    runs = []
    for mode in ("on", "auto"):
        st = init_state(cfg16, TrainerConfig(**kw, fastpath=mode),
                        device="cpu", seed=1)
        step = make_train_step(cfg16, TrainerConfig(**kw, fastpath=mode))
        stream = TokenStream(cfg.vocab_size)
        for k in range(2):
            st, _ = step(st, make_inputs(cfg16, stream, k, BATCH, SEQ,
                                         device="cpu"))
        runs.append(st)
    for k in ("grad_hat", "theta_hat", "nabla"):
        assert torch.equal(runs[0]["lag"][k], runs[1]["lag"][k]), k
    assert torch.equal(runs[0]["theta"], runs[1]["theta"])


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_mixed_tree_is_refused_by_name(arch):
    """A tree that mixes bfloat16 and float32 leaves is no longer refused:
    it initialises into two parts (``fastpath.layout.Parts``: a bfloat16
    buffer over its bfloat16 leaves, a float32 one over the rest) and
    takes a step on the plane, each leaf at its own dtype
    (``tests/test_torch_mixed_train.py`` holds it to the reference)."""
    cfg = get_config(arch).reduced(**BF16)
    assert {t.dtype for t in tree_leaves(model.templates(cfg))} == {
        torch.bfloat16, torch.float32}
    tcfg = TrainerConfig(algo="lag-wk", num_workers=2, fastpath="on")
    st = init_state(cfg, tcfg, device="cpu")
    theta = st["theta"]
    assert (theta.b.dtype, theta.f.dtype) == (torch.bfloat16, torch.float32)
    lo = param_layout(cfg)
    assert [p.num_leaves for p in lo.parts] == [
        sum(d == torch.bfloat16 for d in lo.dtypes),
        sum(d == torch.float32 for d in lo.dtypes)]
    st, m = make_train_step(cfg, tcfg)(st, make_inputs(
        cfg, TokenStream(cfg.vocab_size), 0, BATCH, SEQ, device="cpu"))
    assert np.isfinite(float(m["loss"])) and m["comm_mask"].tolist() == [
        True, True]
    assert all(bool(torch.isfinite(t).all()) for t in st["theta"])


def test_paths_not_ported_at_bf16_raise_by_name(tmp_path):
    """Of the training paths only the gossip graph refuses bfloat16, by
    name (the reference's deep graph step does not trace a bfloat16
    tree); pods, async and the checkpoint's ``save`` take it
    (``tests/test_torch_bf16_topologies.py``,
    ``test_torch_bf16_checkpoint.py``); the legacy per-leaf route trains
    it (``tests/test_torch_mixed_round.py``, ``test_torch_mixed_train.py``)."""
    cfg = get_config("llama3.2-1b").reduced(**BF16)
    tcfg = TrainerConfig(algo="lag-wk", num_workers=2)
    with pytest.raises(NotImplementedError, match="graph topology"):
        lag_trainer.check_trainable(cfg, tcfg, make_topology("graph:2@ring"))
    for spec in ("pods:2", "async:2@1"):
        topo = make_topology(spec)
        st = init_state(cfg, tcfg, device="cpu", topology=topo)
        st, m = make_train_step(cfg, tcfg, topology=topo)(st, make_inputs(
            cfg, TokenStream(cfg.vocab_size), 0, BATCH, SEQ, device="cpu"))
        assert np.isfinite(float(m["loss"]))
        assert st["theta"].dtype == torch.bfloat16
    path = store.save(str(tmp_path), 0, {"theta": st["theta"]})
    like = {"theta": torch.zeros_like(st["theta"])}
    assert torch.equal(store.restore(str(tmp_path), like)[0]["theta"],
                       st["theta"])
    for bad in ("float32", "float64"):      # None or a 2-byte float only
        with pytest.raises(ValueError, match="grad_hat_dtype"):
            TrainerConfig(grad_hat_dtype=bad)
    assert path.endswith("step_0.npz")


def test_wrappers_raise_for_unbuilt_dtype_combinations():
    """No widening fallback: a combination ``kernels.ENTRIES`` does not
    build raises on every device, as the card's launch would."""
    f, b = torch.zeros((2, 8, 128)), torch.zeros((2, 8, 128),
                                                 dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="no instantiation"):
        kernels.delta_sqnorm_blocks(b, f)
    with pytest.raises(TypeError, match="no instantiation"):
        kernels.masked_combine(b, f, torch.ones(2), "add")
    with pytest.raises(TypeError, match="float32"):
        kernels.absmax_blocks(b, b, b)             # the residual is float32
    with pytest.raises(TypeError, match="float32"):
        kernels.sqnorm_blocks(b.double())
    with pytest.raises(TypeError, match="float32"):
        kernels.laq_encode_blocks(b, b, f, torch.zeros((2, 1)), 4,
                                  payload_out=b)
    assert lag_trainer.GRAD_HAT_DTYPES == (None, "bfloat16", "float16")
