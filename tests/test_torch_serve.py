"""The serving slice against the LIVE JAX reference.

Reduced llama3.2-1b, the reference's ``model.init`` parameters carried
across by ``params_from_reference``: the port's ``prefill`` and
teacher-forced ``decode_step`` against the reference's, with
``use_pallas`` off (XLA / the port's plain attention and norm) and on
(interpret-mode Pallas / the kernels' plain versions on the CPU); then the
launcher ``repro_torch.launch.serve`` end to end against the reference's
greedy choices.  The reference's numbers are computed once per module.

Tolerances (float32): logits and KV caches within rtol 1e-5, atol 2e-5 —
the two packages' matmuls and softmaxes sum in other orders (measured
≤ 1.5e-6 on logits of size ~1, ≤ 1.2e-5 on cache entries of size ~10).  A
greedy token must equal the reference's argmax unless the reference's
top-2 logit margin is below MARGIN_TOL = 1e-4, 50× the measured logit
difference: there a tie may break either way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel

from repro_torch.configs import get_config
from repro_torch.configs.shapes import applicable
from repro_torch.launch import serve
from repro_torch.models import common, model
from repro_torch.weights import params_from_reference

B, S, STEPS = 2, 40, 8
RTOL, ATOL, MARGIN_TOL = 1e-5, 2e-5, 1e-4


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def ref():
    """The reference's params, prompts, a token stream for teacher forcing,
    and its prefill + decode outputs with use_pallas off and on."""
    jcfg = jget_config("llama3.2-1b").reduced()
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
    stream = rng.integers(0, jcfg.vocab_size, (B, STEPS), dtype=np.int32)
    out = {}
    # the decode step routes no kernel: one jitted step serves both runs
    decode = jax.jit(lambda prm, c, t, pos: jmodel.decode_step(
        prm, jcfg, c, t, pos))
    for up in (False, True):
        c = jcfg.replace(use_pallas=up)
        last, cache = jax.jit(lambda prm, tk: jmodel.prefill(
            prm, c, {"tokens": tk}, max_len=S + STEPS))(jparams, prompts)
        steps = [(np.asarray(last), jax.tree_util.tree_map(np.asarray,
                                                           cache))]
        for t in range(STEPS):
            logits, cache = decode(jparams, cache,
                                   jnp.asarray(stream[:, t:t + 1]),
                                   jnp.asarray(S + t, jnp.int32))
            steps.append((np.asarray(logits),
                          jax.tree_util.tree_map(np.asarray, cache)))
        out[up] = steps
    return dict(jcfg=jcfg, jparams=jparams,
                params=jax.tree_util.tree_map(np.asarray, jparams),
                prompts=prompts, stream=stream, out=out)


@pytest.fixture(scope="module")
def port(ref):
    cfg = get_config("llama3.2-1b").reduced()
    return cfg, params_from_reference(ref["params"], cfg, device="cpu")


def check_cache(cache, jcache):
    assert cache["tail"] == [] and list(cache["blocks"]) == ["0"]
    for n in ("k", "v"):
        got = cache["blocks"]["0"][n]
        assert tuple(got.shape) == jcache["blocks"]["0"][n].shape
        close(got, jcache["blocks"]["0"][n])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_reference(ref, port, use_pallas):
    cfg, params = port
    with torch.no_grad():
        last, cache = model.prefill(
            params, cfg.replace(use_pallas=use_pallas),
            {"tokens": torch.from_numpy(ref["prompts"])}, max_len=S + STEPS)
    jlast, jcache = ref["out"][use_pallas][0]
    assert tuple(last.shape) == (B, cfg.vocab_size)
    close(last, jlast)
    check_cache(cache, jcache)
    # the padding past the prompt stays zero
    assert not cache["blocks"]["0"]["k"][:, :, S:].any()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_teacher_forced_decode_matches_reference(ref, port, use_pallas):
    cfg, params = port
    c = cfg.replace(use_pallas=use_pallas)
    stream = torch.from_numpy(ref["stream"])
    with torch.no_grad():
        _, cache = model.prefill(params, c,
                                 {"tokens": torch.from_numpy(ref["prompts"])},
                                 max_len=S + STEPS)
        for t in range(STEPS):
            logits, new = model.decode_step(params, c, cache,
                                            stream[:, t:t + 1], S + t)
            assert new is cache                      # written in place
            jlogits, jcache = ref["out"][use_pallas][t + 1]
            assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
            close(logits, jlogits)
            check_cache(cache, jcache)


def test_prefill_routes_norms_through_the_kernel_and_decode_does_not(
        port, monkeypatch):
    """The reference's routing: under use_pallas the prefill's 2 norms per
    layer and the final norm take the kernel (on the CPU its plain
    version); the decode step's norms never do."""
    cfg, params = port
    calls = []
    real = common.rms_ops.rmsnorm
    monkeypatch.setattr(common.rms_ops, "rmsnorm",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    c = cfg.replace(use_pallas=True)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with torch.no_grad():
        _, cache = model.prefill(params, c, {"tokens": toks}, max_len=10)
        assert len(calls) == 2 * cfg.num_layers + 1
        model.decode_step(params, c, cache, toks[:, :1], 8)
        assert len(calls) == 2 * cfg.num_layers + 1
        model.forward(params, c, {"tokens": toks})
        assert len(calls) == 2 * (2 * cfg.num_layers + 1)


def test_forward_kernel_route_matches_xla(ref, port):
    """The port's forward under use_pallas against the reference's XLA
    forward (the reference's own check, tests/test_kernels.py)."""
    cfg, params = port
    toks = ref["prompts"]
    jlogits, _ = jax.jit(lambda prm, tk: jmodel.forward(
        prm, ref["jcfg"], {"tokens": tk}))(ref["jparams"], toks)
    with torch.no_grad():
        logits = model.forward(params, cfg.replace(use_pallas=True),
                               {"tokens": torch.from_numpy(toks)})
    close(logits, jlogits)


def test_serve_main_matches_reference_greedy(ref, port):
    cfg, params = port
    gen, rounds = 8, []
    out = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device",
                      "cpu", "--batch", str(B), "--prompt-len", "24",
                      "--gen", str(gen), "--rounds", "1", "--seed", "3"],
                     on_round=lambda r, t, toks: rounds.append((r, t, toks)),
                     params=params)
    assert len(out) == 1 and len(rounds) == 1
    rnd, timing, toks = rounds[0]
    assert rnd == 0 and toks is out[0] and tuple(toks.shape) == (B, gen)
    assert timing["prefill_ms"] > 0 and timing["decode_ms"] > 0
    assert timing["ms_per_token"] == pytest.approx(timing["decode_ms"]
                                                   / (gen - 1))
    # the reference, teacher-forced on the port's tokens: each greedy
    # choice is its argmax unless its top-2 margin is a near-tie
    prompts = serve.make_prompts(cfg.vocab_size, B, 24, 3 + 1)
    jcfg = ref["jcfg"]
    logits, cache = jax.jit(lambda prm, tk: jmodel.prefill(
        prm, jcfg, {"tokens": tk}, max_len=24 + gen))(ref["jparams"],
                                                      prompts)
    toks = toks.numpy()
    decode = jax.jit(lambda prm, c, tk, pos: jmodel.decode_step(
        prm, jcfg, c, tk, pos))
    for t in range(gen):
        lg = np.asarray(logits).reshape(B, -1)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MARGIN_TOL
        assert np.array_equal(toks[sure, t], lg.argmax(-1)[sure])
        if t + 1 < gen:
            logits, cache = decode(ref["jparams"], cache,
                                   jnp.asarray(toks[:, t:t + 1]),
                                   jnp.asarray(24 + t, jnp.int32))


def test_serve_needs_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "4",
                    "--gen", "2", "--rounds", "1"])


def test_serve_is_seeded():
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "6", "--gen", "3", "--rounds", "2", "--seed", "1"]
    a, b = serve.main(argv), serve.main(argv)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])            # rounds draw new prompts
    np.testing.assert_array_equal(serve.make_prompts(512, 2, 6, 2),
                                  serve.make_prompts(512, 2, 6, 2))


def test_cache_shapes_and_limits(port):
    cfg, params = port
    cache = model.init_cache(cfg, 3, 20, device="cpu")
    shape = (cfg.num_layers, 3, 20, cfg.num_kv_heads, cfg.head_dim)
    assert all(tuple(t.shape) == shape and not t.any()
               for t in cache["blocks"]["0"].values())
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(params, cfg, {"tokens": torch.zeros(
            (1, 9), dtype=torch.int32)}, max_len=8)
    with pytest.raises(ValueError, match="outside the cache"):
        model.decode_step(params, cfg, cache,
                          torch.zeros((3, 1), dtype=torch.int32), 20)
    # a sliding window keeps a rolling buffer of min(window, max_len) slots
    for window, max_len in ((8, 4), (8, 20)):
        rolled = model.init_cache(cfg.replace(window=window), 1, max_len,
                                  device="cpu")
        assert rolled["blocks"]["0"]["k"].shape[2] == min(window, max_len)


def test_applicable_matches_reference_rule():
    from repro.configs.shapes import applicable as japplicable
    cfg, jcfg = get_config("llama3.2-1b"), jget_config("llama3.2-1b")
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert applicable(cfg, shape) == japplicable(jcfg, shape)
    assert applicable(cfg.replace(family="audio"), "decode_32k")[0] is False
    assert applicable(cfg.replace(window=64), "long_500k") == (True, "")
