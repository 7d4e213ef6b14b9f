"""The ``moe`` layer kind (qwen3-moe-30b-a3b, qwen3-moe-235b-a22b) against
the LIVE JAX reference.

The reference's ``init`` parameters are carried across by
``params_from_reference``; inputs are numpy draws handed to both.  Checked:
the configs and ``reduced()`` field for field (the two reduced configs
differ only in ``arch_id``, so the model-level cases run on
qwen3-moe-30b-a3b); the parameter tree, the router float32 under bfloat16
parameters; ``moe.apply`` alone at the reduced widths (E 4, K 2) and at
the published routing widths (E 128, K 8) at a narrow d, for S ∈ {1, 7,
64}, ``capacity_factor`` 1.25 and 0.25 (drops certain) and
``moe_seq_shards`` 1 and 2 — the routing decisions EXACTLY (the top-K
experts, the reference's dispatch one-hot: which (expert, slot) each kept
assignment takes), the capacity buffer BITWISE the reference's
``expert_in`` in every filled slot (an empty slot is +0.0 here, and ±0.0
there: the reference sums 0 · x over the group's tokens), outputs, the load-balance loss and gradients; a zero
router's ties; then the whole model: forward logits and the summed aux
(plain route and, on the CPU, the kernels' plain versions under
``use_pallas``), the loss (cross-entropy + 0.01 · aux) and every gradient,
the cache-building prefill and a teacher-forced decode, ``launch.serve``'s
greedy tokens, and three trainer rounds of lag-wk and laq@4.

The reference's routing is read from its own run: ``jax.lax.top_k`` and
``jnp.einsum`` are wrapped for the call (monkeypatch) so that its top-K,
its dispatch one-hot and its ``expert_in`` are recorded as it computes
them; nothing of the reference is re-implemented here.

Tolerances (float32), the families' (``tests/test_torch_families.py``):
logits, outputs, caches and aux within rtol 1e-5, atol 2e-5; gradients
within rtol 1e-4 and 1e-5 × the leaf's largest |entry| (+1e-8); losses
within rtol 1e-5 (forward) and 1e-4 (three trainer rounds); greedy tokens
equal where the reference's top-2 margin exceeds 1e-4; upload masks equal.
The combine sums a token's K expert outputs in another order than the
reference's einsum over (expert, slot), so outputs are allclose, not
equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import TokenStream as JTokenStream
from repro.data import make_inputs as jmake_inputs
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro.models import moe as jmoe

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.launch import serve
from repro_torch.models import model, moe
from repro_torch.weights import params_from_reference

ARCHS = ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"]
ARCH = ARCHS[0]
B, SEQ, STEPS, PROMPT = 2, 32, 6, 24
RTOL, ATOL, MARGIN_TOL = 1e-5, 2e-5, 1e-4
GRAD_RTOL, GRAD_SCALE_ATOL, GRAD_ZERO_ATOL = 1e-4, 1e-5, 1e-8
LOSS_RTOL, TRAIN_LOSS_RTOL = 1e-5, 1e-4
# moe.apply alone: the reduced routing widths, and the published ones at a
# narrow d (E, K, d, d_ff)
WIDTHS = {"reduced": (4, 2, 256, 512), "published": (128, 8, 64, 32)}
# (S, capacity_factor, seq_shards): S 7 splits into no two shards
CASES = [(S, cf, sh) for S in (1, 7, 64) for cf in (1.25, 0.25)
         for sh in (1, 2) if S % sh == 0]


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one torch thread is the faster (and the tier-1 run
    uses six test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def grads_close(got, want):
    want = np.asarray(want)
    close(got, want, rtol=GRAD_RTOL,
          atol=GRAD_SCALE_ATOL * float(np.abs(want).max()) + GRAD_ZERO_ATOL)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


@functools.lru_cache(maxsize=None)
def pair():
    """(reference cfg, port cfg, reference params, port params) of the
    reduced qwen3-moe-30b-a3b."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def reference_fns():
    """The reference's jitted model functions on the reduced config, shared
    by the model-level tests."""
    jcfg = pair()[0]
    return dict(
        forward=jax.jit(lambda p, x: jmodel.forward(p, jcfg, x)),
        loss=jax.jit(jax.value_and_grad(
            lambda p, x: jmodel.loss_fn(p, jcfg, x))),
        prefill=jax.jit(lambda p, x, max_len: jmodel.prefill(
            p, jcfg, x, max_len=max_len), static_argnums=2),
        decode=jax.jit(lambda p, c, t, pos: jmodel.decode_step(
            p, jcfg, c, t, pos)))


# ---------------------------------------------------------------------------
# Config, tree, init
# ---------------------------------------------------------------------------

def test_registry_has_every_reference_arch():
    from repro.configs import ALL_ARCHS as J_ALL
    from repro_torch.configs import ALL_ARCHS
    assert sorted(ALL_ARCHS) == sorted(J_ALL)
    assert len(ALL_ARCHS) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field of the port's config equals the reference's, full and
    reduced (experts cut to 4, top-k to 2), but ``remat``: off by default
    in the port (the same values either way, a second forward's cost)."""
    import dataclasses
    names = [f.name for f in dataclasses.fields(get_config(arch))]
    for got, want in ((get_config(arch), jget_config(arch)),
                      (get_config(arch).reduced(),
                       jget_config(arch).reduced())):
        for f in names:
            if f == "remat":
                assert want.remat and not got.remat, arch
            else:
                assert getattr(got, f) == getattr(want, f), (arch, f)
    r = get_config(arch).reduced()
    assert (r.num_experts, r.top_k, r.capacity_factor,
            r.moe_seq_shards) == (4, 2, 1.25, 1)
    other = get_config(ARCHS[1 - ARCHS.index(arch)]).reduced()
    assert r == other.replace(arch_id=arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_and_own_init(arch):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax.tree_util.tree_map(np.asarray, pair()[2])
    params = params_from_reference(jparams, cfg, device="cpu")
    jleaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for (path, want), got in zip(jleaves, leaves):
        assert tuple(got.shape) == want.shape, jax.tree_util.keystr(path)
        assert np.array_equal(got.numpy(), want)
    m = params["blocks"]["0"]["moe"]
    L, d, E, ff = cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff
    assert m["router"].shape == (L, d, E)
    assert m["w_gate"].shape == m["w_up"].shape == (L, E, d, ff)
    assert m["w_down"].shape == (L, E, ff, d)
    # the port's own init draws the same tree: unit norm scales, fan-in
    # truncated normals
    own = model.init(cfg, device="cpu", seed=1)
    for (path, want), got in zip(jleaves, tree_leaves(own)):
        assert tuple(got.shape) == want.shape, jax.tree_util.keystr(path)
    om = own["blocks"]["0"]["moe"]
    for name, fan_in in (("router", d), ("w_gate", d), ("w_up", d),
                         ("w_down", ff)):
        std = float(om[name].std()) * fan_in ** 0.5
        assert 0.8 < std < 0.95, (name, std)   # N(0, 1) cut at ±2: 0.880
        assert float(om[name].abs().max()) <= 2.0 / fan_in ** 0.5 + 1e-6
    # the reference makes the router float32 whatever param_dtype says
    # (its tree's dtypes by tracing alone), and so does the port
    jb = jax.eval_shape(functools.partial(
        jmodel.init, cfg=jcfg.replace(param_dtype="bfloat16")),
        jax.random.PRNGKey(0))["blocks"]["0"]["moe"]
    bm = params_from_reference(jparams, cfg.replace(param_dtype="bfloat16"),
                               device="cpu")["blocks"]["0"]["moe"]
    assert jb["router"].dtype == jnp.float32
    assert bm["router"].dtype == torch.float32
    for n in ("w_gate", "w_up", "w_down"):
        assert jb[n].dtype == jnp.bfloat16 and bm[n].dtype == torch.bfloat16
    assert torch.equal(bm["router"], m["router"])


def test_unknown_kind_is_refused_by_name():
    cfg = get_config("llama3.2-1b").replace(block_pattern=("xyz",))
    with pytest.raises(NotImplementedError, match="xyz"):
        model.param_shapes(cfg)


# ---------------------------------------------------------------------------
# moe.apply alone
# ---------------------------------------------------------------------------

def layer_configs(width, cf):
    E, K, d, ff = WIDTHS[width]
    kw = dict(d_model=d, d_ff=ff, num_experts=E, top_k=K, capacity_factor=cf)
    return jget_config(ARCH).reduced(**kw), get_config(ARCH).reduced(**kw)


@functools.lru_cache(maxsize=None)
def layer_params(width):
    """The reference's ``moe.init`` draw at ``width`` (numpy)."""
    jcfg = layer_configs(width, 1.25)[0]
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jmoe.init, static_argnums=1)(jax.random.PRNGKey(1), jcfg))


def layer_input(width, S, seed=0):
    d = WIDTHS[width][2]
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def reference_run(monkeypatch, jp, x, jcfg, shards):
    """The reference's ``moe.apply`` with its top-K and its einsums
    recorded as it traces them, all returned from one jitted call: → (y,
    aux, {"top_k": (values, indices), subscripts: result})."""
    top_k, einsum = jax.lax.top_k, jnp.einsum

    def run(p, x):
        seen = {}

        def rec_top_k(a, k):
            seen["top_k"] = top_k(a, k)
            return seen["top_k"]

        def rec_einsum(spec, *ops, **kw):
            seen[spec] = einsum(spec, *ops, **kw)
            return seen[spec]

        with monkeypatch.context() as m:
            m.setattr(jax.lax, "top_k", rec_top_k)
            m.setattr(jnp, "einsum", rec_einsum)
            y, aux = jmoe.apply(p, x, jcfg, seq_shards=shards)
        return y, aux, seen

    y, aux, seen = jax.jit(run)(jp, x)
    return np.asarray(y), float(aux), seen


def dispatch_onehot(r: moe.Routing, E: int) -> np.ndarray:
    """The port's decisions as the reference's (g, S_g, E, C) dispatch."""
    g, Sg, K = r.experts.shape
    out = np.zeros((g, Sg, E, r.capacity), np.float32)
    ex, sl, kept = (t.numpy() for t in (r.experts, r.slots, r.kept))
    for gi, s, k in zip(*np.nonzero(kept)):
        out[gi, s, ex[gi, s, k], sl[gi, s, k]] = 1.0
    return out


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("S,cf,shards", CASES)
def test_moe_routing_and_output_match_reference(monkeypatch, width, S, cf,
                                                shards):
    jcfg, cfg = layer_configs(width, cf)
    jp, x = layer_params(width), layer_input(width, S)
    jy, jaux, seen = reference_run(monkeypatch, jp, x, jcfg, shards)
    p = to_torch(jp)
    xg = moe.groups(torch.from_numpy(x), shards)
    r = moe.route(p, xg, cfg)
    expert_in, _ = moe.dispatch(xg, r, cfg)
    # the routing decisions, exactly
    jvals, jidx = (np.asarray(a) for a in seen["top_k"])
    assert np.array_equal(r.experts.numpy(), jidx)
    close(r.gates, jvals / jvals.sum(-1, keepdims=True))
    jdispatch = np.asarray(seen["gske,gskec->gsec"])
    assert jdispatch.shape[-1] == r.capacity
    assert np.array_equal(dispatch_onehot(r, cfg.num_experts), jdispatch)
    # the capacity buffer: its filled slots bit for bit, its empty slots
    # zero (the reference's sums of 0 · x carry the sign of x)
    jin = np.asarray(seen["gsec,gsd->egcd"])
    got = expert_in.numpy()
    assert got.shape == jin.shape
    filled = np.broadcast_to(np.transpose(jdispatch.sum(1), (1, 0, 2))[
        ..., None] > 0, got.shape)
    assert np.array_equal(got.view(np.int32)[filled],
                          jin.view(np.int32)[filled])
    assert not got[~filled].any() and not jin[~filled].any()
    drops = int((~r.kept).sum())
    if cf == 0.25 and S > 1:
        assert drops > 0                       # capacity forces drops
    if cf == 1.25 and width == "reduced":
        assert r.capacity * cfg.num_experts >= S // shards * cfg.top_k
    y, aux = moe.apply(p, torch.from_numpy(x), cfg, seq_shards=shards)
    close(y, jy)
    np.testing.assert_allclose(float(aux), jaux, rtol=RTOL)


GRAD_CASES = [("published", 64, 1.25, 2), ("published", 64, 0.25, 1),
              ("reduced", 7, 1.25, 1)]


@pytest.mark.parametrize("width,S,cf,shards", GRAD_CASES)
def test_moe_grads_match_reference(width, S, cf, shards):
    """Gradients of Σ y · w + aux for x, the router and the experts."""
    jcfg, cfg = layer_configs(width, cf)
    jp, x = layer_params(width), layer_input(width, S, seed=1)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.apply(p, x, jcfg, seq_shards=shards)
        return jnp.sum(y * w) + aux

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    p = {k: v.requires_grad_() for k, v in to_torch(jp).items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply(p, xt, cfg, seq_shards=shards)
    names = sorted(p)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)) + aux,
                                [p[n] for n in names] + [xt])
    for n, got in zip(names, grads):
        grads_close(got, jg_p[n])
    grads_close(grads[-1], jg_x)


def test_zero_router_ties_go_to_the_lower_experts(monkeypatch):
    """Every probability equal: the reference's top-K is experts 0..K-1,
    and so is the port's; with 64 tokens on 8 of 128 experts at C = 5,
    the tokens past the fifth are dropped alike."""
    jcfg, cfg = layer_configs("published", 1.25)
    jp = dict(layer_params("published"))
    jp["router"] = np.zeros_like(jp["router"])
    x = layer_input("published", 64, seed=3)
    jy, jaux, seen = reference_run(monkeypatch, jp, x, jcfg, 1)
    p = to_torch(jp)
    r = moe.route(p, moe.groups(torch.from_numpy(x), 1), cfg)
    K = cfg.top_k
    want = np.broadcast_to(np.arange(K), r.experts.shape)
    assert np.array_equal(np.asarray(seen["top_k"][1]), want)
    assert np.array_equal(r.experts.numpy(), want)
    assert np.array_equal(dispatch_onehot(r, cfg.num_experts),
                          np.asarray(seen["gske,gskec->gsec"]))
    assert r.capacity == 5 and int(r.kept.sum()) == B * 5 * K
    y, aux = moe.apply(p, torch.from_numpy(x), cfg)
    close(y, jy)
    np.testing.assert_allclose(float(aux), jaux, rtol=RTOL)


def test_seq_shards_must_split_the_sequence():
    cfg = layer_configs("reduced", 1.25)[1]
    p = to_torch(layer_params("reduced"))
    with pytest.raises(ValueError, match="does not split"):
        moe.apply(p, torch.from_numpy(layer_input("reduced", 7)), cfg,
                  seq_shards=2)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def batches(step=1):
    jcfg, cfg = pair()[:2]
    jb = jmake_inputs(jcfg, JTokenStream(jcfg.vocab_size), step, B, SEQ)
    b = make_inputs(cfg, TokenStream(cfg.vocab_size), step, B, SEQ,
                    device="cpu")
    return jb, b


def test_forward_and_aux_match_reference(reference_fns):
    jcfg, cfg, jparams, params = pair()
    jb, b = batches()
    jlogits, jaux = reference_fns["forward"](jparams, jb)
    with torch.no_grad():
        for up in (False, True):
            logits, aux = model.forward_with_aux(
                params, cfg.replace(use_pallas=up), b)
            assert logits.shape == jlogits.shape
            close(logits, jlogits)
            np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
            assert torch.equal(model.forward(
                params, cfg.replace(use_pallas=up), b), logits)
    assert float(jaux) > 0.0


def test_loss_and_grads_match_reference(reference_fns):
    """The loss is the cross-entropy + 0.01 · the layers' aux; every
    gradient, the router's and the experts' included."""
    jcfg, cfg, jparams, params = pair()
    jb, b = batches(step=2)
    jloss, jgrads = reference_fns["loss"](jparams, jb)
    leaves, treedef = tree_flatten(params)
    req = [t.clone().requires_grad_() for t in leaves]
    loss = model.loss_fn(tree_unflatten(treedef, req), cfg, b)
    grads = torch.autograd.grad(loss, req)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    jg = jax.tree_util.tree_leaves(jgrads)
    assert len(jg) == len(grads)
    for got, want in zip(grads, jg):
        grads_close(got, want)
    # the aux term is in both losses, at the reference's weight
    with torch.no_grad():
        aux = float(model.forward_with_aux(params, cfg, b)[1])
    jaux = float(reference_fns["forward"](jparams, jb)[1])
    assert model.AUX_WEIGHT == 0.01 and aux > 0.0
    np.testing.assert_allclose(loss.item() - 0.01 * aux,
                               float(jloss) - 0.01 * jaux, rtol=LOSS_RTOL)


def test_prefill_and_decode_match_reference(reference_fns):
    """Prefill caches and last logits, then a teacher-forced decode (one
    token: B groups of one, C = 1)."""
    jcfg, cfg, jparams, params = pair()
    max_len = PROMPT + STEPS
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    stream = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
    jlast, jcache = reference_fns["prefill"](jparams, {"tokens": prompts},
                                             max_len)
    with torch.no_grad():
        for up in (False, True):
            c = cfg.replace(use_pallas=up)
            last, cache = model.prefill(params, c, {
                "tokens": torch.from_numpy(prompts)}, max_len=max_len)
            close(last, jlast)
            jc = jcache
            for n in ("k", "v"):
                assert cache["blocks"]["0"][n].shape == (
                    cfg.num_layers, B, max_len, cfg.num_kv_heads,
                    cfg.head_dim)
                close(cache["blocks"]["0"][n], jc["blocks"]["0"][n])
            for t in range(STEPS):
                logits, cache = model.decode_step(
                    params, c, cache, torch.from_numpy(stream[:, t:t + 1]),
                    PROMPT + t)
                jlogits, jc = reference_fns["decode"](
                    jparams, jc, jnp.asarray(stream[:, t:t + 1]),
                    jnp.asarray(PROMPT + t, jnp.int32))
                close(logits, jlogits)
                for n in ("k", "v"):
                    close(cache["blocks"]["0"][n], jc["blocks"]["0"][n])


def test_serve_matches_reference_greedy(reference_fns):
    jcfg, cfg, jparams, params = pair()
    gen = 6
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", str(B), "--prompt-len", str(PROMPT),
                      "--gen", str(gen), "--rounds", "1", "--seed", "3"],
                     params=params)
    toks = out[0].numpy()
    assert toks.shape == (B, gen)
    prompts = serve.make_prompts(cfg.vocab_size, B, PROMPT, 3 + 1)
    logits, cache = reference_fns["prefill"](jparams, {"tokens": prompts},
                                             PROMPT + gen)
    for t in range(gen):
        lg = np.asarray(logits).reshape(B, -1)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MARGIN_TOL
        assert sure.any()
        assert np.array_equal(toks[sure, t], lg.argmax(-1)[sure])
        if t + 1 < gen:
            logits, cache = reference_fns["decode"](
                jparams, cache, jnp.asarray(toks[:, t:t + 1]),
                jnp.asarray(PROMPT + t, jnp.int32))


@functools.lru_cache(maxsize=None)
def reference_rounds(algo):
    jcfg = pair()[0]
    jt = JTrainerConfig(algo=algo, num_workers=2, lr=0.3)
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    params = jax.tree_util.tree_map(np.asarray, jstate["params"])
    jstep = jax.jit(jmake_train_step(jcfg, jt))
    stream, out = JTokenStream(jcfg.vocab_size), []
    for k in range(3):
        jstate, m = jstep(jstate, jmake_inputs(jcfg, stream, k, 4, 16))
        out.append((float(m["loss"]), np.asarray(m["comm_mask"]).tolist()))
    return params, out


@pytest.mark.parametrize("algo", ["lag-wk", "laq@4"])
def test_trainer_matches_reference(algo):
    """Three rounds at W = 2 (the plane forced on, its kernels' plain
    versions on the CPU): equal masks, losses within rtol 1e-4."""
    params, want = reference_rounds(algo)
    cfg = pair()[1]
    tcfg = TrainerConfig(algo=algo, num_workers=2, lr=0.3, fastpath="on")
    state = init_state(cfg, tcfg, device="cpu", params=params_from_reference(
        params, cfg, device="cpu"))
    step = make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size)
    for k, (loss, mask) in enumerate(want):
        state, m = step(state, make_inputs(cfg, stream, k, 4, 16,
                                           device="cpu"))
        np.testing.assert_allclose(float(m["loss"]), loss,
                                   rtol=TRAIN_LOSS_RTOL)
        assert m["comm_mask"].tolist() == mask
    assert want[0][1] == [True, True]
