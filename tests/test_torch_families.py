"""Every architecture of the dense block kind against the LIVE JAX
reference: llama3.2-3b, llama3.2-1b-sw, granite-8b, command-r-35b,
qwen2-vl-7b and hubert-xlarge, at their reduced configs.

The reference's ``model.init`` parameters are carried across by
``params_from_reference``; batches come from each package's own
``make_inputs`` and are held equal bit for bit.  Checked per arch: the
forward logits (plain route and, on the CPU, the kernels' plain versions
under ``use_pallas``), the loss and every gradient, the cache-building
prefill and a teacher-forced decode (llama3.2-1b-sw with a prompt longer
than its reduced window of 64, so the rolling cache wraps), and the
launcher ``repro_torch.launch.serve`` end to end against the reference's
greedy choices (hubert, encoder-only, is refused).  ``split_batch`` is held
to the reference's on a VLM batch at W = 2 and 3, and three trainer rounds
of lag-wk and laq@4 for hubert and qwen2-vl to the reference's trainer.

Tolerances (float32; the two packages' products and softmaxes sum in
other orders): logits and caches within rtol 1e-5, atol 2e-5 (the serving
tests' bound; measured ≤ 4e-6 on logits of size ~1); gradients within rtol
1e-4 and an atol of 1e-5 × the leaf's largest |entry| (a gradient entry is
a sum over every position, so its rounding follows the leaf's scale, not
its own: measured ≤ 3.1e-6 on a LayerNorm leaf whose entries reach 3.8,
8e-7 of it), plus 1e-8 for the key bias ``bk``, whose gradient is zero in
exact arithmetic (it shifts all of a query's scores alike) and round-off
on both sides (≤ 1.3e-9 measured); losses within rtol
1e-5 (forward) and rtol 1e-4 (three trainer rounds, the trainer tests'
bound).  A greedy token must equal the reference's argmax unless the
reference's top-2 margin is below MARGIN_TOL = 1e-4.  Upload masks are
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
from repro.engine.topology import split_batch as jsplit_batch
from repro.models import model as jmodel

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.engine.topology import split_batch
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.weights import params_from_reference

ARCHS = ["llama3.2-3b", "llama3.2-1b-sw", "granite-8b", "command-r-35b",
         "qwen2-vl-7b", "hubert-xlarge"]
DECODERS = [a for a in ARCHS if a != "hubert-xlarge"]
B, SEQ, STEPS = 2, 32, 6
RTOL, ATOL, MARGIN_TOL = 1e-5, 2e-5, 1e-4
GRAD_RTOL, GRAD_SCALE_ATOL, GRAD_ZERO_ATOL = 1e-4, 1e-5, 1e-8
LOSS_RTOL, TRAIN_LOSS_RTOL = 1e-5, 1e-4


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def prompt_len(cfg) -> int:
    """A prompt longer than the window, so the rolling cache wraps."""
    return cfg.window + 16 if cfg.window else 24


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def batches(arch, step=1):
    jcfg, cfg = pair(arch)[:2]
    jb = jmake_inputs(jcfg, JTokenStream(jcfg.vocab_size), step, B, SEQ)
    b = make_inputs(cfg, TokenStream(cfg.vocab_size), step, B, SEQ,
                    device="cpu")
    return jb, b


def test_registry_has_the_dense_kind_and_refuses_the_rest():
    from repro.configs import ALL_ARCHS as J_ALL
    from repro_torch.configs import ALL_ARCHS
    for arch in ARCHS + ["llama3.2-1b"]:
        assert get_config(arch) == get_config(arch)        # a value type
        got, want = get_config(arch), jget_config(arch)
        for f in ("arch_id", "family", "num_layers", "d_model", "vocab_size",
                  "num_heads", "num_kv_heads", "head_dim", "d_ff", "causal",
                  "window", "rope", "rope_theta", "block_pattern", "norm",
                  "act", "use_bias", "tie_embeddings"):
            assert getattr(got, f) == getattr(want, f), (arch, f)
    # the reference's eleven archs, every layer kind of their patterns
    # ported, and an unknown kind refused by name
    assert sorted(ALL_ARCHS) == sorted(J_ALL) and len(ALL_ARCHS) == 11
    kinds = {k for a in J_ALL for k in jget_config(a).block_pattern}
    assert kinds == set(model.PORTED_KINDS)
    cfg = get_config("llama3.2-1b").replace(block_pattern=("xyz",))
    with pytest.raises(NotImplementedError, match="xyz"):
        model.param_shapes(cfg)
    with pytest.raises(KeyError, match="the port has"):
        get_config("xyz")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference(arch):
    jcfg, cfg, jparams, params = pair(arch)
    jleaves, jdef = jax.tree_util.tree_flatten_with_path(jparams)
    leaves, _ = tree_flatten(params)
    # JAX's sorted key order, leaf for leaf ("head", "mask_emb" included)
    assert len(leaves) == len(jleaves)
    for (path, want), got in zip(jleaves, leaves):
        assert tuple(got.shape) == want.shape, jax.tree_util.keystr(path)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert ("head" in params) == (not cfg.tie_embeddings)
    assert ("mask_emb" in params) == (cfg.family == "audio")
    assert ("embed" in params) == (cfg.family != "audio")
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jparams)
    assert jax.tree_util.tree_leaves(shapes, is_leaf=lambda s: isinstance(
        s, tuple)) == [tuple(t.shape) for t in tree_leaves(
            model.templates(cfg))]
    # the port's own init draws the same tree, biases and mask_emb zero
    own = model.init(cfg, device="cpu", seed=1)
    for (path, want), got in zip(jleaves, tree_leaves(own)):
        key = jax.tree_util.keystr(path)
        assert tuple(got.shape) == want.shape
        if any(n in key for n in ("'bq'", "'bk'", "'bv'", "'b_up'",
                                  "'b_down'", "'bias'", "'mask_emb'")):
            assert not got.any(), key
    other = "llama3.2-1b" if arch == "hubert-xlarge" else "hubert-xlarge"
    with pytest.raises(ValueError, match="does not match"):
        params_from_reference(jax.tree_util.tree_map(np.asarray, jparams),
                              get_config(other).reduced(), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, cfg, jparams, params = pair(arch)
    jb, b = batches(arch)
    jlogits, _ = jax.jit(lambda p, x: jmodel.forward(p, jcfg, x))(jparams, jb)
    with torch.no_grad():
        for up in (False, True):
            logits = model.forward(params, cfg.replace(use_pallas=up), b)
            assert logits.shape == jlogits.shape
            close(logits, jlogits)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
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
        close(got, want, rtol=GRAD_RTOL,
              atol=GRAD_SCALE_ATOL * float(np.abs(want).max())
              + GRAD_ZERO_ATOL)
    if cfg.family == "vlm":
        # the vision prefix has no targets: the loss averages the text
        assert b["targets"].shape[1] == SEQ - b["vision_embeds"].shape[1]


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill (a VLM with its vision prefix) and a teacher-forced decode;
    the rolling cache of llama3.2-1b-sw wraps inside the prompt."""
    jcfg, cfg, jparams, params = pair(arch)
    S = prompt_len(cfg)
    max_len = S + STEPS
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    stream = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
    jin, tin = {"tokens": prompts}, {"tokens": torch.from_numpy(prompts)}
    if cfg.family == "vlm":
        ve = (rng.standard_normal((B, 4, cfg.d_model)) * 0.02).astype(
            np.float32)
        jin["vision_embeds"], tin["vision_embeds"] = ve, torch.from_numpy(ve)
    start = S + (4 if cfg.family == "vlm" else 0)
    jlast, jcache = jax.jit(lambda p, x: jmodel.prefill(
        p, jcfg, x, max_len=max_len + 4))(jparams, jin)
    decode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, jcfg, c, t,
                                                             pos))
    L = min(cfg.window, max_len + 4) if cfg.window else max_len + 4
    with torch.no_grad():
        for up in (False, True):
            c = cfg.replace(use_pallas=up)
            last, cache = model.prefill(params, c, tin, max_len=max_len + 4)
            close(last, jlast)
            jc = jcache
            for n in ("k", "v"):
                assert cache["blocks"]["0"][n].shape == (
                    cfg.num_layers, B, L, cfg.num_kv_heads, cfg.head_dim)
                close(cache["blocks"]["0"][n], jc["blocks"]["0"][n])
            for t in range(STEPS):
                logits, cache = model.decode_step(
                    params, c, cache, torch.from_numpy(stream[:, t:t + 1]),
                    start + t)
                jlogits, jc = decode(jparams, jc, jnp.asarray(
                    stream[:, t:t + 1]), jnp.asarray(start + t, jnp.int32))
                close(logits, jlogits)
                for n in ("k", "v"):
                    close(cache["blocks"]["0"][n], jc["blocks"]["0"][n])
    if cfg.window:
        assert S > cfg.window                      # the cache has wrapped


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_matches_reference_greedy(arch):
    jcfg, cfg, jparams, params = pair(arch)
    S, gen, rounds = prompt_len(cfg), 6, []
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", str(B), "--prompt-len", str(S), "--gen",
                      str(gen), "--rounds", "1", "--seed", "3"],
                     on_round=lambda r, t, toks: rounds.append(toks),
                     params=params)
    toks = out[0].numpy()
    assert toks.shape == (B, gen) and rounds[0] is out[0]
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


def test_serve_refuses_hubert_with_the_reference_reason():
    from repro.configs.shapes import applicable as japplicable
    _, reason = japplicable(jget_config("hubert-xlarge"), "decode_32k")
    with pytest.raises(SystemExit, match=reason):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu", "--batch", "1", "--prompt-len", "4", "--gen", "2",
                    "--rounds", "1"])
    cfg = get_config("hubert-xlarge").reduced()
    with pytest.raises(ValueError, match="no decode step"):
        model.decode_step(pair("hubert-xlarge")[3], cfg, None,
                          torch.zeros((1, 1), dtype=torch.int32), 0)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-7b",
                                  "granite-8b"])
def test_batches_bitwise_reference(arch):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    for step, worker in ((0, 0), (3, 1)):
        jb = jmake_inputs(jcfg, JTokenStream(jcfg.vocab_size, seed=4), step,
                          3, 20, worker)
        b = make_inputs(cfg, TokenStream(cfg.vocab_size, seed=4), step, 3,
                        20, worker, device="cpu")
        assert sorted(b) == sorted(jb)
        for k in jb:
            want = np.asarray(jb[k])
            assert b[k].numpy().dtype == want.dtype, k
            assert np.array_equal(b[k].numpy(), want), k
    if cfg.family == "vlm":
        assert b["vision_embeds"].shape == (3, 5, cfg.d_model)
        assert b["positions3"].shape == (3, 3, 20)


@pytest.mark.parametrize("W", [2, 3])
def test_split_batch_matches_reference_on_a_vlm_batch(W):
    """positions3 (3, B, S) splits on its batch axis 1 into (W, 3, B/W, S);
    a scalar leaf is broadcast to (W,)."""
    jcfg, cfg = jget_config("qwen2-vl-7b").reduced(), \
        get_config("qwen2-vl-7b").reduced()
    jb = jmake_inputs(jcfg, JTokenStream(jcfg.vocab_size), 1, 6, 16)
    b = make_inputs(cfg, TokenStream(cfg.vocab_size), 1, 6, 16, device="cpu")
    # distinct rows per sample, so a wrong axis cannot pass
    p3 = np.arange(3 * 6 * 16, dtype=np.int32).reshape(3, 6, 16)
    jb["positions3"], b["positions3"] = jnp.asarray(p3), torch.from_numpy(p3)
    jb["pos"], b["pos"] = jnp.asarray(5, jnp.int32), torch.tensor(5)
    want, got = jsplit_batch(jb, W), split_batch(b, W)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert got["positions3"].shape == (W, 3, 6 // W, 16)
    with pytest.raises(ValueError, match="not divisible"):
        split_batch(b, 4)


@functools.lru_cache(maxsize=None)
def reference_rounds(arch, algo):
    jcfg = jget_config(arch).reduced()
    jt = JTrainerConfig(algo=algo, num_workers=2, lr=0.3)
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    params = jax.tree_util.tree_map(np.asarray, jstate["params"])
    jstep = jax.jit(jmake_train_step(jcfg, jt))
    stream, out = JTokenStream(jcfg.vocab_size), []
    for k in range(3):
        jstate, m = jstep(jstate, jmake_inputs(jcfg, stream, k, 4, 16))
        out.append((float(m["loss"]), np.asarray(m["comm_mask"]).tolist()))
    return params, out


@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-7b"])
@pytest.mark.parametrize("algo", ["lag-wk", "laq@4"])
def test_trainer_matches_reference(arch, algo):
    """Three rounds at W = 2 (the plane forced on, its kernels' plain
    versions on the CPU) through split_batch: equal masks, losses within
    rtol 1e-4."""
    params, want = reference_rounds(arch, algo)
    cfg = get_config(arch).reduced()
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
