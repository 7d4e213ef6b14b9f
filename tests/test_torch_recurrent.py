"""The recurrent and state-space layer kinds against the LIVE JAX
reference: recurrentgemma-9b (``rec`` + ``lattn`` and its unscanned tail)
at ``reduced(num_layers=8)`` — two superblocks of (rec, rec, lattn) and a
two-layer rec tail — and mamba2-370m (``ssd``) at ``reduced()``.

The reference's ``init`` parameters are carried across by
``params_from_reference``; inputs are numpy draws handed to both.  Checked:
``rglru.apply``/``decode`` and ``mamba2.apply``/``decode`` alone (S not a
power of two, S below the reduced chunk of 32, S % 32 ≠ 0); the doubling
scan against a sequential one, where running products of a underflow;
forward logits on the plain route and under ``use_pallas`` (the kernels'
plain versions); the loss and every gradient; the cache-building prefill
(h, conv windows, SSM state, rolling K/V) and a teacher-forced decode past
the reduced window of 64; ``launch.serve``'s greedy tokens; three trainer
rounds of lag-wk and laq@4.

Tolerances (float32).  Logits, outputs and caches within rtol 1e-5, atol
2e-5, the families' bound.  The RG-LRU's recurrence runs as a doubling
scan here and as ``jax.lax.associative_scan`` in the reference: both
associate the same products in other orders, which costs a few ulp of h
(measured ≤ 1.4e-6 on h of size ~1 and ≤ 1.6e-5 on logits of size ~4, in
the same bound).  Gradients within rtol 1e-4 and 1e-5 × the leaf's largest
|entry| (+1e-8), losses within rtol 1e-5 (forward) and 1e-4 (three
trainer rounds), greedy tokens equal where the reference's top-2 margin
exceeds 1e-4, upload masks equal — all the families' bounds; LAQ's losses
after a code has flipped on a rounding boundary within its float32 bound
1e-3 (:func:`test_trainer_matches_reference`).
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
from repro.models import mamba2 as jmamba2
from repro.models import model as jmodel
from repro.models import rglru as jrglru

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step, param_layout)
from repro_torch.fastpath.layout import SUB
from repro_torch.launch import serve
from repro_torch.models import mamba2, model, rglru
from repro_torch.weights import params_from_reference

ARCHS = {"recurrentgemma-9b": dict(num_layers=8), "mamba2-370m": {}}
B, SEQ, STEPS = 2, 32, 6
PROMPT = 80         # past the reduced window of 64, no multiple of 32
RTOL, ATOL, MARGIN_TOL = 1e-5, 2e-5, 1e-4
GRAD_RTOL, GRAD_SCALE_ATOL, GRAD_ZERO_ATOL = 1e-4, 1e-5, 1e-8
LOSS_RTOL, TRAIN_LOSS_RTOL = 1e-5, 1e-4
# LAQ's code flips (tests/test_torch_trainer.py measures the mechanism):
# steps within 5e-4, a flipped code within 2e-3 of a rounding boundary,
# losses after a flip within float32 LAQ's rtol 1e-3
LAQ_STEP_RTOL, LAQ_BOUNDARY_TOL, LAQ_LOSS_RTOL = 5e-4, 2e-3, 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one torch thread is the faster (and the driver runs
    six test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def configs(arch):
    return (jget_config(arch).reduced(**ARCHS[arch]),
            get_config(arch).reduced(**ARCHS[arch]))


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, cfg = configs(arch)
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


# ---------------------------------------------------------------------------
# Config, tree, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_matches_reference(arch):
    got, want = get_config(arch), jget_config(arch)
    for f in ("arch_id", "family", "num_layers", "d_model", "vocab_size",
              "num_heads", "num_kv_heads", "head_dim", "d_ff", "window",
              "rope", "rope_theta", "block_pattern", "norm", "act",
              "tie_embeddings", "ssm_state", "ssm_headdim", "ssm_expand",
              "ssm_chunk", "ssm_conv", "rglru_expand", "d_inner",
              "ssm_heads", "num_superblocks", "tail_layers"):
        assert getattr(got, f) == getattr(want, f), f
    jr, r = configs(arch)
    for f in ("num_layers", "d_model", "ssm_state", "ssm_chunk", "window",
              "num_kv_heads", "head_dim", "tail_layers"):
        assert getattr(r, f) == getattr(jr, f), f


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_from_reference_and_own_init(arch):
    jcfg, cfg, jparams, params = pair(arch)
    jleaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for (path, want), got in zip(jleaves, leaves):
        assert tuple(got.shape) == want.shape, jax.tree_util.keystr(path)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert len(params["tail"]) == cfg.tail_layers
    # the port's own init: the same tree, the reference's constant leaves
    own = model.init(cfg, device="cpu", seed=1)
    for (path, want), got in zip(jleaves, tree_leaves(own)):
        key = jax.tree_util.keystr(path)
        assert tuple(got.shape) == want.shape, key
        want = torch.from_numpy(np.array(want))
        if any(f"'{n}'" in key for n in ("conv_b", "b_a", "b_i", "A_log",
                                          "dt_bias", "D", "norm_scale",
                                          "scale")):
            assert torch.equal(got, want), key
        if "'lam'" in key:           # linspace(2, 8, dr): ends and steps
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        if "'conv_w'" in key:
            assert 0.07 < float(got.std()) < 0.13, key


def test_float32_leaves_stay_float32():
    cfg = get_config("recurrentgemma-9b").reduced(
        num_layers=4, param_dtype="bfloat16")
    t = model.templates(cfg)
    rec = t["blocks"]["0"]["rec"]
    assert rec["lam"].dtype == rec["b_a"].dtype == torch.float32
    assert rec["w_x"].dtype == torch.bfloat16
    assert t["tail"][0]["rec"]["b_i"].dtype == torch.float32
    mix = model.templates(get_config("mamba2-370m").reduced(
        param_dtype="bfloat16"))["blocks"]["0"]["mixer"]
    assert mix["A_log"].dtype == mix["D"].dtype == torch.float32
    assert mix["in_proj"].dtype == torch.bfloat16


def test_moe_is_refused_by_name():
    """``PORTED_KINDS`` is every kind the reference's ``layer_init`` takes,
    each with the reference's layer tree; any other kind is refused by
    name, as the reference refuses it."""
    cfg = get_config("llama3.2-1b").reduced(num_experts=4, top_k=2)
    jcfg = jget_config("llama3.2-1b").reduced(num_experts=4, top_k=2)
    for kind in model.PORTED_KINDS:
        want = jax.eval_shape(functools.partial(
            jmodel.layer_init, kind=kind, cfg=jcfg), jax.random.PRNGKey(0))
        got = model.layer_shapes(kind, cfg)
        assert jax.tree_util.tree_map(lambda a: tuple(a.shape), want) == got
    assert sorted(model.PORTED_KINDS) == ["dense", "lattn", "moe", "rec",
                                          "ssd"]
    with pytest.raises(ValueError, match="xyz"):
        jmodel.layer_init(jax.random.PRNGKey(0), "xyz", jcfg)
    with pytest.raises(NotImplementedError, match="xyz"):
        model.param_shapes(cfg.replace(block_pattern=("xyz",)))


# ---------------------------------------------------------------------------
# The layers alone
# ---------------------------------------------------------------------------

def layer_inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    xs = rng.standard_normal((B, STEPS, 1, cfg.d_model)).astype(np.float32)
    return x, xs


@functools.lru_cache(maxsize=None)
def jitted(jmod, arch):
    """The reference layer's (init, apply with state, decode), jitted."""
    jcfg = configs(arch)[0]
    return (jax.jit(lambda k: jmod.init(k, jcfg)),
            jax.jit(lambda p, x: jmod.apply(p, x, jcfg, return_state=True)),
            jax.jit(lambda p, x, c: jmod.decode(p, x, c, jcfg)))


def check_layer(jmod, mod, arch, S, seed):
    """apply with its decode state, then STEPS decode steps from it."""
    jcfg, cfg = configs(arch)
    jinit, japply, jdecode = jitted(jmod, arch)
    jp = jinit(jax.random.PRNGKey(seed))
    p = to_torch(jp)
    x, xs = layer_inputs(cfg, S, seed)
    jy, jst = japply(jp, jnp.asarray(x))
    with torch.no_grad():
        y = mod.apply(p, torch.from_numpy(x), cfg)
        y2, st = mod.apply(p, torch.from_numpy(x), cfg, return_state=True)
    assert torch.equal(y, y2)
    close(y, jy)
    assert sorted(st) == sorted(jst)
    for n in jst:
        assert tuple(st[n].shape) == jst[n].shape, n
        assert st[n].dtype == getattr(torch, str(jst[n].dtype)), n
        close(st[n], jst[n])
    for t in range(STEPS):
        jy, jst = jdecode(jp, jnp.asarray(xs[:, t]), jst)
        with torch.no_grad():
            y, st2 = mod.decode(p, torch.from_numpy(xs[:, t]), st, cfg)
        assert st2 is st                         # updated in place
        close(y, jy)
        for n in jst:
            close(st[n], jst[n])


@pytest.mark.parametrize("S", [1, 3, 20, 77])
def test_rglru_apply_and_decode_match_reference(S):
    check_layer(jrglru, rglru, "recurrentgemma-9b", S, seed=S)


@pytest.mark.parametrize("S", [1, 20, 64, 77])
def test_mamba2_apply_and_decode_match_reference(S):
    """S below the chunk of 32, two whole chunks, and 77 = 2·32 + 13 (the
    padded steps must leave the state alone)."""
    check_layer(jmamba2, mamba2, "mamba2-370m", S, seed=S)


def test_init_caches_match_reference():
    for jmod, mod, arch in ((jrglru, rglru, "recurrentgemma-9b"),
                            (jmamba2, mamba2, "mamba2-370m")):
        jcfg, cfg = configs(arch)
        want = jmod.init_cache(jcfg, 3)
        got = mod.init_cache(cfg, 3, device="cpu")
        assert sorted(got) == sorted(want)
        for n in want:
            assert tuple(got[n].shape) == want[n].shape
            assert not got[n].any()


def sequential_scan(a, b):
    h, out = torch.zeros_like(b[:, 0]), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100])
def test_linear_scan_is_the_recurrence(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.1, 1.0, (2, S, 3)))
    b = torch.from_numpy(rng.standard_normal((2, S, 3)))
    torch.testing.assert_close(rglru.linear_scan(a, b), sequential_scan(a, b),
                               rtol=1e-12, atol=1e-12)


def test_linear_scan_underflow_is_harmless():
    """a = 0.36 (Λ = 2, r = 1) over 4096 steps: running products of a
    underflow to 0 in the doubling scan (0.36^128 < 2^-149); h stays finite
    and within float32 rounding of a float64 sequential scan."""
    rng = np.random.default_rng(0)
    a = torch.full((1, 4096, 4), 0.36)
    b = torch.from_numpy(rng.standard_normal((1, 4096, 4)).astype(np.float32))
    got = rglru.linear_scan(a, b)
    want = sequential_scan(a.double(), b.double())
    assert bool(torch.isfinite(got).all())
    assert float(torch.prod(a[0, :128, 0])) == 0.0
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def batches(arch, step=1):
    jcfg, cfg = configs(arch)
    jb = jmake_inputs(jcfg, JTokenStream(jcfg.vocab_size), step, B, SEQ)
    b = make_inputs(cfg, TokenStream(cfg.vocab_size), step, B, SEQ,
                    device="cpu")
    return jb, b


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_reference(arch):
    jcfg, cfg, jparams, params = pair(arch)
    jb, b = batches(arch)
    jlogits, _ = jax.jit(lambda p, x: jmodel.forward(p, jcfg, x))(jparams, jb)
    with torch.no_grad():
        for up in (False, True):
            logits = model.forward(params, cfg.replace(use_pallas=up), b)
            assert logits.shape == jlogits.shape
            close(logits, jlogits)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_reference(arch):
    """Every gradient, the tail's and the SSD's masked decay's included."""
    jcfg, cfg, jparams, params = pair(arch)
    jb, b = batches(arch, step=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, x: jmodel.loss_fn(p, jcfg, x)))(jparams, jb)
    leaves, treedef = tree_flatten(params)
    req = [t.clone().requires_grad_() for t in leaves]
    loss = model.loss_fn(tree_unflatten(treedef, req), cfg, b)
    grads = torch.autograd.grad(loss, req)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    jg = jax.tree_util.tree_leaves(jgrads)
    assert len(jg) == len(grads)
    for got, want in zip(grads, jg):
        want = np.asarray(want)
        assert bool(torch.isfinite(got).all())
        close(got, want, rtol=GRAD_RTOL,
              atol=GRAD_SCALE_ATOL * float(np.abs(want).max())
              + GRAD_ZERO_ATOL)


def check_cache(cache, jcache):
    got = tree_leaves(cache)
    want = jax.tree_util.tree_leaves(jcache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg, jparams, params = pair(arch)
    S = PROMPT
    max_len = S + STEPS
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    stream = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
    jlast, jcache = jax.jit(lambda p, x: jmodel.prefill(
        p, jcfg, x, max_len=max_len))(jparams, {"tokens": prompts})
    decode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, jcfg, c, t,
                                                             pos))
    with torch.no_grad():
        for up in (False, True):
            c = cfg.replace(use_pallas=up)
            last, cache = model.prefill(params, c,
                                        {"tokens": torch.from_numpy(prompts)},
                                        max_len=max_len)
            close(last, jlast)
            check_cache(cache, jcache)
            assert len(cache["tail"]) == cfg.tail_layers
            jc = jcache
            for t in range(STEPS):
                logits, cache = model.decode_step(
                    params, c, cache, torch.from_numpy(stream[:, t:t + 1]),
                    S + t)
                jlogits, jc = decode(jparams, jc, jnp.asarray(
                    stream[:, t:t + 1]), jnp.asarray(S + t, jnp.int32))
                close(logits, jlogits)
                check_cache(cache, jc)
    if cfg.window:
        assert S > cfg.window                      # the cache has wrapped


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_cache_matches_reference(arch):
    jcfg, cfg = configs(arch)
    want = jmodel.init_cache(jcfg, 2, 100)
    got = model.init_cache(cfg, 2, 100, device="cpu")
    assert len(tree_leaves(got)) == len(jax.tree_util.tree_leaves(want))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape and not g.any()


def test_depth_below_one_superblock():
    """recurrentgemma at 2 layers: no superblock (zero-length stacks), a
    two-layer rec tail; forward, prefill and decode as the reference."""
    jcfg = jget_config("recurrentgemma-9b").reduced(num_layers=2)
    cfg = get_config("recurrentgemma-9b").reduced(num_layers=2)
    assert cfg.num_superblocks == 0 and cfg.tail_layers == 2
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(1),
                                                     jcfg)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 9),
                                             dtype=np.int32)
    jlast, jcache = jax.jit(lambda p, x: jmodel.prefill(
        p, jcfg, x, max_len=12))(jparams, {"tokens": toks})
    with torch.no_grad():
        last, cache = model.prefill(params, cfg,
                                    {"tokens": torch.from_numpy(toks)}, 12)
        close(last, jlast)
        check_cache(cache, jcache)
        logits, cache = model.decode_step(params, cfg, cache,
                                          torch.from_numpy(toks[:, :1]), 9)
    jlogits, _ = jax.jit(lambda p, c, t: jmodel.decode_step(
        p, jcfg, c, t, jnp.asarray(9, jnp.int32)))(jparams, jcache,
                                                   jnp.asarray(toks[:, :1]))
    close(logits, jlogits)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_matches_reference_greedy(arch):
    jcfg, cfg, jparams, params = pair(arch)
    S, gen = PROMPT, 6
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", str(B), "--prompt-len", str(S), "--gen",
                      str(gen), "--rounds", "1", "--seed", "3"],
                     params=params, cfg=cfg)
    toks = out[0].numpy()
    assert toks.shape == (B, gen)
    prompts = serve.make_prompts(cfg.vocab_size, B, S, 3 + 1)
    logits, cache = jax.jit(lambda p, tk: jmodel.prefill(
        p, jcfg, {"tokens": tk}, max_len=S + gen))(jparams, prompts)
    decode = jax.jit(lambda p, c, tk, pos: jmodel.decode_step(p, jcfg, c,
                                                              tk, pos))
    for t in range(gen):
        lg = np.asarray(logits).reshape(B, -1)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MARGIN_TOL
        assert np.array_equal(toks[sure, t], lg.argmax(-1)[sure])
        if t + 1 < gen:
            logits, cache = decode(jparams, cache,
                                   jnp.asarray(toks[:, t:t + 1]),
                                   jnp.asarray(S + t, jnp.int32))


@functools.lru_cache(maxsize=None)
def reference_rounds(arch, algo):
    """The reference's initial parameters, (loss, mask) of three rounds and
    its lag state after round 0."""
    jcfg = configs(arch)[0]
    jt = JTrainerConfig(algo=algo, num_workers=2, lr=0.3)
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    params = jax.tree_util.tree_map(np.asarray, jstate["params"])
    jstep = jax.jit(jmake_train_step(jcfg, jt))
    stream, out = JTokenStream(jcfg.vocab_size), []
    for k in range(3):
        jstate, m = jstep(jstate, jmake_inputs(jcfg, stream, k, 4, 16))
        out.append((float(m["loss"]), np.asarray(m["comm_mask"]).tolist()))
        if k == 0:
            lag0 = jax.tree_util.tree_map(np.asarray, jstate["lag"])
    return params, out, lag0


def round0_code_flips(cfg, state, jlag):
    """Round 0 uploads ĝ_m = step · codes from ĝ = 0 on both sides: per
    (worker, leaf) the steps agree, the codes are equal but where the
    reference's v/step sat on a rounding boundary (|resid / step| ≈ ½, so
    a last-bit difference of the gradient rounds it the other way), and
    there they differ by one.  Returns the number of such flips."""
    lo = param_layout(cfg)
    flat = lambda t: t.reshape(2, -1).double().numpy()
    gh = flat(state["lag"]["grad_hat"])
    jgh = flat(lo.flatten_stacked(to_torch(jlag["grad_hat"])))
    jres = flat(lo.flatten_stacked(to_torch(jlag["resid"])))
    flips = 0
    for m in range(2):
        for i, size in enumerate(lo.sizes):
            seg = slice(lo.leaf_sub_offsets[i] * SUB,
                        lo.leaf_sub_offsets[i] * SUB + size)
            a, b = gh[m, seg], jgh[m, seg]
            sa, sb = np.abs(a).max() / 7.0, np.abs(b).max() / 7.0
            if sb == 0.0:
                assert sa == 0.0
                continue
            assert abs(sa - sb) <= LAQ_STEP_RTOL * sb
            ca, cb = np.round(a / sa), np.round(b / sb)
            flip = ca != cb
            assert np.abs(ca - cb).max() <= 1
            assert np.all(np.abs(jres[m, seg][flip] / sb)
                          >= 0.5 - LAQ_BOUNDARY_TOL)
            flips += int(flip.sum())
    return flips


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("algo", ["lag-wk", "laq@4"])
def test_trainer_matches_reference(arch, algo):
    """Three rounds at W = 2 (the plane forced on, its kernels' plain
    versions on the CPU): equal masks, losses within rtol 1e-4.  For LAQ,
    a code that flips on a rounding boundary moves its coordinate by a
    whole step · α (recurrentgemma: 3 of 2.2 M codes in round 0, one of
    them 2.9 % of a w_down leaf's largest entry); the two trajectories then
    part by more than round-off, and later losses are held to float32
    LAQ's bound, rtol 1e-3 (measured 2.2e-4 at round 2; ROADMAP queue 3)."""
    params, want, jlag0 = reference_rounds(arch, algo)
    cfg = configs(arch)[1]
    tcfg = TrainerConfig(algo=algo, num_workers=2, lr=0.3, fastpath="on")
    state = init_state(cfg, tcfg, device="cpu", params=params_from_reference(
        params, cfg, device="cpu"))
    step = make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size)
    flips = 0
    for k, (loss, mask) in enumerate(want):
        state, m = step(state, make_inputs(cfg, stream, k, 4, 16,
                                           device="cpu"))
        np.testing.assert_allclose(
            float(m["loss"]), loss,
            rtol=TRAIN_LOSS_RTOL if flips == 0 else LAQ_LOSS_RTOL)
        assert m["comm_mask"].tolist() == mask
        if k == 0 and algo.startswith("laq"):
            flips = round0_code_flips(cfg, state, jlag0)
    assert want[0][1] == [True, True]
