"""bfloat16 serving and the reference's remaining ``ModelConfig`` fields,
against the LIVE JAX reference.

bfloat16: every layer kind (``dense`` llama3.2-1b and hubert-xlarge,
``rec`` + ``lattn`` recurrentgemma-9b, ``ssd`` mamba2-370m, ``moe``
qwen3-moe-30b-a3b), reduced, at ``dtype = param_dtype = "bfloat16"``.  The
reference's bfloat16 parameters are carried across by
``params_from_reference`` (bit for bit: tested).  The port's bfloat16
forward, cache-building prefill and teacher-forced decode are held to the
reference's float32 run on the same (widened) weights within twice the
reference's own bfloat16 error: max|port_bf16 − ref_f32| ≤ 2 · max|ref_bf16
− ref_f32|, for the reference's plain route and its ``use_pallas`` route
(interpret-mode Pallas).  The two packages round the same bfloat16
products in other orders, so the port is not held to the reference's
bfloat16 bits, only to its error.

The kernels' bfloat16 arithmetic on the CPU: the port's plain RMSNorm
against the reference's ``rmsnorm_2d`` in interpret mode (its two
roundings to bfloat16), and the facts that the flash kernel's bfloat16
designs rest on: a product of two bfloat16 values is exact in float32 (so
q·kᵀ is one bfloat16 product on the tensor cores), and every bfloat16
value is unchanged by TF32 rounding (``cvt.rna.tf32``), as is its product
with the power-two scales 1/8 and 1/16 (so a TF32 product of bfloat16
operands is exact too).  The ``wgmma`` kernel's own arithmetic is emulated
in ``tests/test_torch_kernels.py``.

``ModelConfig``: the five fields build for every arch, with the
reference's defaults but for ``remat`` (off in the port); ``remat`` gives
losses and gradients equal to ``remat=False`` bit for bit on every layer
kind and saves fewer tensors for the backward; ``embed_onehot`` against
the reference's; ``scan_unroll`` is the same program; ``act_shard_axes``
raises with no mesh on both sides.  Every bfloat16 config
trains: an all-bfloat16 one (``tests/test_torch_bf16_train.py``) and one
whose tree mixes bfloat16 and float32 leaves, in two parts
(``tests/test_torch_mixed_train.py``).

The CUDA kernels' bfloat16 instantiations run only on the card
(``tests/test_torch_kernels_cuda.py``'s cases, ``chip_smoke.py`` phase
18).
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import TokenStream as JTokenStream
from repro.data import make_inputs as jmake_inputs
from repro.kernels.rmsnorm import rmsnorm as jrms_kernel
from repro.models import model as jmodel

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.dist.lag_trainer import TrainerConfig, init_state
from repro_torch.kernels.rmsnorm import ref as t_rms_ref
from repro_torch.models import model
from repro_torch.weights import params_from_reference

torch.set_num_threads(1)

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
#: one arch per layer kind
KINDS = {"llama3.2-1b": {}, "hubert-xlarge": {},
         "recurrentgemma-9b": dict(num_layers=5),     # a superblock + tail
         "mamba2-370m": {}, "qwen3-moe-30b-a3b": {}}
DECODERS = [a for a in KINDS if a != "hubert-xlarge"]
B, SEQ, STEPS = 2, 48, 3
#: the port's bfloat16 error against the reference's float32 run, as a
#: multiple of the reference's own bfloat16 error (measured 1.00–1.39)
ERR_RATIO = 2.0
#: float32 logits of the two packages on the same batch (the families
#: tests' bound)
RTOL, ATOL = 1e-5, 2e-5


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def err(a, b) -> float:
    return float(np.max(np.abs(f32(a).astype(np.float64)
                               - f32(b).astype(np.float64))))


def to_torch(a) -> torch.Tensor:
    """A numpy (or jax) array as a tensor, bfloat16 bit for bit."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x.astype(np.float64)))
    return np.ldexp(1.0, e - 8)


@functools.lru_cache(maxsize=None)
def weights(arch):
    """(reference bf16 cfg, its params; the same weights widened to float32
    under the float32 cfg; the port's bf16 cfg and params)."""
    kw = KINDS[arch]
    jcfg = jget_config(arch).reduced(**kw, **BF16)
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    jcfg32 = jget_config(arch).reduced(**kw)
    jparams32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                       jparams)
    cfg = get_config(arch).reduced(**kw, **BF16)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, jcfg32, jparams32, cfg, params


def batch(arch):
    """The reference's batch for ``arch`` and the same arrays as tensors."""
    jcfg = weights(arch)[0]
    jb = jmake_inputs(jcfg, JTokenStream(jcfg.vocab_size), 1, B, SEQ)
    return jb, {k: to_torch(v) for k, v in jb.items()}


def within_ratio(port, ref_bf, ref_32, what):
    got, own = err(port, ref_32), err(ref_bf, ref_32)
    assert np.isfinite(f32(port)).all(), what
    assert got <= ERR_RATIO * own, (what, got, own)


# ---------------------------------------------------------------------------
# bfloat16 serving: every layer kind against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(KINDS))
def test_weights_carried_across_at_bfloat16_bit_for_bit(arch):
    jcfg, jparams, _, _, cfg, params = weights(arch)
    jleaves = jax.tree_util.tree_leaves(jparams)
    leaves, _ = tree_flatten(params)
    assert len(leaves) == len(jleaves)
    kinds = set()
    for got, want in zip(leaves, jleaves):
        want = np.asarray(want)
        kinds.add(str(want.dtype))
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
        else:                           # the float32 leaves stay float32
            assert got.dtype == torch.float32 and want.dtype == np.float32
            assert np.array_equal(got.numpy(), want)
    assert "bfloat16" in kinds


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", list(KINDS))
def test_bf16_forward_within_the_reference_error(arch, use_pallas):
    jcfg, jparams, jcfg32, jparams32, cfg, params = weights(arch)
    jb, b = batch(arch)
    fwd = jax.jit(lambda p, x, c: jmodel.forward(p, c, x)[0],
                  static_argnums=2)
    ref_bf = fwd(jparams, jb, jcfg.replace(use_pallas=use_pallas))
    ref_32 = fwd(jparams32, jb, jcfg32)
    with torch.no_grad():
        got = model.forward(params, cfg.replace(use_pallas=use_pallas), b)
    assert got.dtype == torch.bfloat16 and got.shape == ref_bf.shape
    within_ratio(got, ref_bf, ref_32, f"{arch} forward")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", DECODERS)
def test_bf16_prefill_and_decode_within_the_reference_error(arch,
                                                            use_pallas):
    """The cache-building prefill's last logits and the teacher-forced
    decode steps' logits; the caches carry the bfloat16 K/V (float32 h and
    SSM state) into the decode."""
    jcfg, jparams, jcfg32, jparams32, cfg, params = weights(arch)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (B, SEQ), dtype=np.int32)
    stream = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
    max_len = SEQ + STEPS
    jcfg = jcfg.replace(use_pallas=use_pallas)
    runs = {}
    for key, c, p in (("bf", jcfg, jparams), ("32", jcfg32, jparams32)):
        last, cache = jax.jit(lambda p_, x, c_=c: jmodel.prefill(
            p_, c_, {"tokens": x}, max_len=max_len))(p, prompts)
        dec = jax.jit(lambda p_, ca, t, pos, c_=c: jmodel.decode_step(
            p_, c_, ca, t, pos))
        out = [last]
        for t in range(STEPS):
            logits, cache = dec(p, cache, jnp.asarray(stream[:, t:t + 1]),
                                jnp.asarray(SEQ + t, jnp.int32))
            out.append(logits)
        runs[key] = out
    c = cfg.replace(use_pallas=use_pallas)
    with torch.no_grad():
        last, cache = model.prefill(params, c, {"tokens": torch.from_numpy(
            prompts)}, max_len=max_len)
        got = [last]
        for t in range(STEPS):
            logits, cache = model.decode_step(
                params, c, cache, torch.from_numpy(stream[:, t:t + 1]),
                SEQ + t)
            got.append(logits)
    for i, g in enumerate(got):
        assert g.dtype == torch.bfloat16
        within_ratio(g, runs["bf"][i], runs["32"][i],
                     f"{arch} {'prefill' if i == 0 else f'decode {i}'}")


def test_serve_launcher_takes_a_bfloat16_config():
    from repro_torch.launch import serve
    cfg = get_config("llama3.2-1b").reduced(**BF16, use_pallas=True)
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                      "16", "--gen", "4", "--rounds", "1"], cfg=cfg)
    assert out[0].shape == (2, 4)
    assert bool(((out[0] >= 0) & (out[0] < cfg.vocab_size)).all())


# ---------------------------------------------------------------------------
# The kernels' bfloat16 arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 256), (24, 512), (64, 2048),
                                   (16, 3072)])
def test_plain_rmsnorm_within_one_ulp_of_the_reference_kernel(shape):
    """The port's plain RMSNorm (the CPU route and the oracle) against the
    reference's Pallas ``rmsnorm_2d`` in interpret mode, bfloat16 x and
    scale: within one bfloat16 ulp of the output (the mean of squares sums
    in another order, which may move y across a rounding boundary; it did
    not here: the two are equal)."""
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    s = rng.standard_normal(shape[1:]).astype(ml_dtypes.bfloat16)
    want = np.asarray(jrms_kernel.rmsnorm_2d(jnp.asarray(x), jnp.asarray(s),
                                             interpret=True))
    got = t_rms_ref.rmsnorm(to_torch(x), to_torch(s))
    assert got.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16
    a, w = f32(got), want.astype(np.float32)
    assert np.all(np.abs(a - w) <= bf16_ulp(np.maximum(np.abs(a),
                                                       np.abs(w))))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, ties away from zero."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_bfloat16_values_are_exact_in_tf32():
    """Every finite bfloat16 value, and its product with the flash
    kernels' folded scales 64^-1/2 = 1/8 and 256^-1/2 = 1/16, is unchanged
    by TF32 rounding, but for float32 subnormals (below 2^-126, where a
    scaled value's last bits leave TF32's 10); a product of two bfloat16
    values is exact in float32.  So q·kᵀ on bfloat16 operands is one exact
    product, in TF32 as on the bfloat16 tensor cores (where the ``wgmma``
    kernel's products rest on the last fact alone)."""
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).float()
    every = every[torch.isfinite(every)]
    tiny = torch.finfo(torch.float32).tiny
    for scale in (1.0, 0.125, 0.0625):
        x = every * scale
        normal = (x.abs() >= tiny) | (x == 0)
        assert torch.equal(tf32_rna(x[normal]), x[normal]), scale
        assert int((~normal).sum()) < 0.02 * x.numel()   # the subnormals
    # a float32 value that is not bfloat16 moves (the check has teeth)
    y = torch.tensor([1.0 + 2 ** -12], dtype=torch.float32)
    assert not torch.equal(tf32_rna(y), y)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
            .bfloat16().float() for _ in range(2))
    assert torch.equal((a.double() * b.double()).float().double(),
                       a.double() * b.double())


def test_bf16_instantiations_and_their_shared_memory():
    """Both kernels take bfloat16 (and float16) beside float32, launches
    counted apart, each with a second kernel for what the first does not
    take (RMSNorm's rows kernel, the wide flash kernel) in every dtype;
    RMSNorm's dtypes share one source, flash attention's bfloat16 kernel
    has its own (``flash_attention_bf16.cu``: q and a two-stage K/V ring of
    bfloat16 tiles, no lo buffer; float16 is the same source built again),
    each dtype's wide kernel in its tensor-core kernel's library, each
    block within Hopper's 227 KB."""
    from repro_torch.kernels.flash_attention import flash_attention as t_fa
    from repro_torch.kernels.rmsnorm import rmsnorm as t_rms
    for mod, name, second in ((t_rms, "rmsnorm", "rmsnorm_rows"),
                              (t_fa, "flash_attention",
                               "flash_attention_wide")):
        assert set(mod.ENTRIES) == {torch.float32, torch.bfloat16,
                                    torch.float16}
        assert set(mod.LAUNCHES) == {n + sfx for n in (name, second)
                                     for sfx in ("", "_bf16", "_f16")}
    assert set(t_rms.LIBRARY.entry_points) == {
        e for table in (t_rms.ENTRIES, t_rms.ROWS_ENTRIES)
        for _, e in table.values()}
    for dtype, (_, entry) in t_fa.ENTRIES.items():
        assert set(t_fa.LIBRARIES[dtype].entry_points) == {
            entry, t_fa.WIDE_ENTRIES[dtype][1]}
    assert t_fa.LIBRARY_BF16.source.name == "flash_attention_bf16.cu" \
        == t_fa.LIBRARY_F16.source.name
    assert t_fa.SHARED_BYTES_BF16 == {64: 83008, 80: 103488, 128: 99392,
                                      256: 197696}
    for hd, nbytes in t_fa.SHARED_BYTES_BF16.items():
        assert nbytes <= 232448


# ---------------------------------------------------------------------------
# The reference's remaining ModelConfig fields
# ---------------------------------------------------------------------------

FIELDS = ("remat", "scan_unroll", "embed_onehot", "act_shard_axes",
          "act_shard_seq")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_fields_build_for_every_arch(arch):
    """The reference's defaults, but ``remat`` is off in the port: it
    changes no value, costs a second forward, and no driven training
    shape's peak needs it."""
    want, got = jget_config(arch), get_config(arch)
    for f in FIELDS[1:]:
        assert getattr(got, f) == getattr(want, f), (arch, f)
    assert want.remat and not got.remat
    cfg = get_config(arch, remat=True, scan_unroll=True, embed_onehot=True)
    assert (cfg.remat, cfg.scan_unroll, cfg.embed_onehot) == (True, True,
                                                               True)
    model.param_shapes(cfg)


def loss_and_grads(params, cfg, b):
    leaves, treedef = tree_flatten(params)
    req = [l.detach().requires_grad_() for l in leaves]
    loss = model.loss_fn(tree_unflatten(treedef, req), cfg, b)
    return loss, torch.autograd.grad(loss, req)


def saved_tensors(params, cfg, b) -> int:
    """Tensors the forward keeps for the backward, outside checkpoints."""
    n = [0]

    def pack(t):
        n[0] += 1
        return t
    leaves, treedef = tree_flatten(params)
    req = [l.detach().requires_grad_() for l in leaves]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss_fn(tree_unflatten(treedef, req), cfg, b)
    return n[0]


@pytest.mark.parametrize("arch", list(KINDS))
def test_remat_gradients_equal_bit_for_bit(arch):
    """Losses and every gradient with ``remat=True`` equal
    ``remat=False`` bit for bit: the checkpointed superblocks recompute the
    same ops in the same order (the moe kind's puts and the RG-LRU
    doubling scan included), and the unscanned tail is not wrapped.  The
    forward keeps fewer tensors for the backward."""
    cfg = get_config(arch).reduced(remat=True, **KINDS[arch])
    assert cfg.num_superblocks >= 1
    params = model.init(cfg, device="cpu", seed=3)
    _, b = batch(arch)
    l0, g0 = loss_and_grads(params, cfg.replace(remat=False), b)
    l1, g1 = loss_and_grads(params, cfg, b)
    assert torch.equal(l0, l1)
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))
    assert saved_tensors(params, cfg, b) < saved_tensors(
        params, cfg.replace(remat=False), b)
    with torch.no_grad():            # no gradients: nothing is wrapped
        assert torch.equal(model.forward(params, cfg, b),
                           model.forward(params, cfg.replace(remat=False),
                                         b))


def test_embed_onehot_matches_the_reference():
    """``embed_onehot`` logits and gradients against the reference's one-hot
    lookup (its sharding constraint is moot with no mesh), float32: the
    port's gather gives its values; the forward and decode equal those
    without the field bit for bit."""
    jcfg = jget_config("llama3.2-1b").reduced(embed_onehot=True)
    cfg = get_config("llama3.2-1b").reduced(embed_onehot=True)
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    jb = jmake_inputs(jcfg, JTokenStream(jcfg.vocab_size), 1, B, SEQ)
    b = {k: to_torch(v) for k, v in jb.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, x: jmodel.loss_fn(p, jcfg, x)))(jparams, jb)
    loss, grads = loss_and_grads(params, cfg, b)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(jg).max(), 1e-30))
    with torch.no_grad():
        np.testing.assert_allclose(
            model.forward(params, cfg, b).numpy(),
            np.asarray(jmodel.forward(jparams, jcfg, jb)[0]), rtol=RTOL,
            atol=ATOL)
        tokens = b["tokens"]
        assert torch.equal(model._lookup(params, cfg, tokens),
                           model._lookup(params, cfg.replace(
                               embed_onehot=False), tokens))
        # decode looks tokens up the same way
        cache = model.init_cache(cfg, B, 4, device="cpu")
        a, _ = model.decode_step(params, cfg, cache, tokens[:, :1], 0)
        cache = model.init_cache(cfg, B, 4, device="cpu")
        c, _ = model.decode_step(params, cfg.replace(embed_onehot=False),
                                 cache, tokens[:, :1], 0)
        assert torch.equal(a, c)


def test_scan_unroll_is_the_same_program():
    cfg = get_config("recurrentgemma-9b").reduced(num_layers=5)
    params = model.init(cfg, device="cpu", seed=1)
    _, b = batch("recurrentgemma-9b")
    with torch.no_grad():
        assert torch.equal(model.forward(params, cfg, b), model.forward(
            params, cfg.replace(scan_unroll=True), b))


def test_act_shard_axes_raise_without_a_mesh_as_the_reference_does():
    """A non-empty ``act_shard_axes`` pins activations to mesh axes: with
    no mesh the reference's ``with_sharding_constraint`` raises in
    ``forward``, and so does the port, naming the missing mesh; prefill
    (which the reference does not constrain) runs; ``act_shard_seq`` alone
    is the identity."""
    jcfg = jget_config("llama3.2-1b").reduced(act_shard_axes=("data",))
    cfg = get_config("llama3.2-1b").reduced(act_shard_axes=("data",))
    jparams = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    tokens = np.zeros((B, 8), np.int32)
    with pytest.raises(RuntimeError, match="mesh"):
        jmodel.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    params = model.init(cfg, device="cpu", seed=0)
    tin = {"tokens": torch.from_numpy(tokens)}
    with pytest.raises(RuntimeError, match="mesh_context"):
        model.forward(params, cfg, tin)
    jmodel.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, 12)
    with torch.no_grad():
        last, _ = model.prefill(params, cfg, tin, max_len=12)
        plain = cfg.replace(act_shard_axes=())
        assert torch.equal(last, model.prefill(params, plain, tin,
                                               max_len=12)[0])
        assert torch.equal(
            model.forward(params, plain.replace(act_shard_seq=True), tin),
            model.forward(params, plain, tin))


def test_training_a_bfloat16_config_is_refused():
    """Every bfloat16 config trains: one of bfloat16 leaves only in one
    bfloat16 buffer (``tests/test_torch_bf16_train.py``), one whose tree
    keeps float32 leaves (the MoE router here) in two, each leaf at its own
    dtype, never widened to a float32 plane
    (``tests/test_torch_mixed_train.py``)."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced(**BF16)
    st = init_state(cfg, TrainerConfig(algo="lag-wk", num_workers=2),
                    device="cpu")
    leaves = tree_leaves(model.templates(cfg))
    assert {t.dtype for t in leaves} == {torch.bfloat16, torch.float32}
    assert (st["theta"].b.dtype, st["theta"].f.dtype) == (torch.bfloat16,
                                                          torch.float32)
    router = [t for t in leaves if t.dtype == torch.float32]
    assert st["theta"].f.numel() >= sum(t.numel() for t in router)
    dense = get_config("llama3.2-1b").reduced(**BF16)
    assert {t.dtype for t in tree_leaves(model.templates(dense))} \
        == {torch.bfloat16}
    st = init_state(dense, TrainerConfig(algo="lag-wk", num_workers=2),
                    device="cpu")
    assert st["theta"].dtype == st["lag"]["grad_hat"].dtype == torch.bfloat16
