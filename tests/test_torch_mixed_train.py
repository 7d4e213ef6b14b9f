"""bfloat16 training of the trees that keep float32 leaves, against the
LIVE JAX reference.

The reduced bfloat16 configs of mamba2-370m (``A_log``, ``dt_bias``, ``D``
float32), qwen3-moe-30b-a3b (the router float32) and recurrentgemma-9b
(RG-LRU's ``b_a``, ``b_i`` float32), W = 2, lr 0.3, batch 4 × 16, from the
reference's bfloat16 ``init_state`` weights: the port's trainer on the
plane (``fastpath="on"``), on the plain route (``"auto"``) and on the legacy
per-leaf route (``use_pallas_comm=True``) against the reference's jitted
``make_train_step`` (its default route, and its ``use_pallas_comm=True``
route with its Pallas kernels in interpret mode).  lag-wk runs 3 rounds;
laq@4 the rounds the reference runs before its jitted step fails (LAQ's
float32 payload promotes its θ, ROADMAP queue 3 (c)), at most 3.

Tolerances: masks equal; losses within ``ERR_RATIO`` (2) × the reference's
own bfloat16 error against its float32 run on the widened weights (the
largest over the rounds, as ``test_torch_bf16_train`` holds the all-
bfloat16 llama); the plane and the plain route agree bit for bit in
lag-wk.  The state keeps each leaf at its own dtype: θ, ∇, ĝ (and LAQ's
float32 residual) are ``Parts`` pairs of a bfloat16 and a float32 buffer,
every parameter leaf a view of its part, none widened; the bfloat16
state takes about half the float32 config's bytes.
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

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step, param_layout,
                                          params_of)
from repro_torch.fastpath.layout import MixedLayout, Parts
from repro_torch.weights import params_from_reference

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
ARCHS = ["mamba2-370m", "qwen3-moe-30b-a3b", "recurrentgemma-9b"]
#: the port's bfloat16 loss error against the reference's float32 run, as
#: a multiple of the reference's own bfloat16 error (test_torch_bf16.py)
ERR_RATIO = 2.0
BATCH, SEQ, STEPS, TW = 4, 16, 3, 2


@functools.lru_cache(maxsize=None)
def bf16_weights(arch):
    """The reference's bfloat16 init (its ``init_state``), as numpy."""
    st = jinit_state(jax.random.PRNGKey(0), jget_config(arch).reduced(**BF16),
                     JTrainerConfig(algo="gd", num_workers=TW))
    return jax.tree_util.tree_map(np.asarray, st["params"])


@functools.lru_cache(maxsize=None)
def reference_run(arch, bf16, algo, steps, legacy=False):
    """(losses, masks) of the reference's jitted step from the bfloat16
    weights (widened for the float32 config), stopping at the round its
    jitted step refuses (queue 3 (c))."""
    params = bf16_weights(arch)
    jcfg = jget_config(arch).reduced(**BF16) if bf16 \
        else jget_config(arch).reduced()
    if not bf16:
        params = jax.tree_util.tree_map(lambda x: x.astype(np.float32),
                                        params)
    jt = JTrainerConfig(algo=algo, num_workers=TW, lr=0.3,
                        use_pallas_comm=legacy)
    state = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    state["params"] = jax.tree_util.tree_map(jnp.asarray, params)
    step = jax.jit(jmake_train_step(jcfg, jt))
    stream = JTokenStream(jcfg.vocab_size)
    losses, masks = [], []
    for k in range(steps):
        try:
            state, m = step(state, jmake_inputs(jcfg, stream, k, BATCH, SEQ))
        except TypeError as e:         # the promoted carry of queue 3 (c)
            assert "carry" in str(e), e
            break
        losses.append(float(m["loss"]))
        masks.append(np.asarray(m["comm_mask"]).tolist())
    return tuple(losses), tuple(map(tuple, masks))


def port_run(arch, tcfg, steps):
    cfg = get_config(arch).reduced(**BF16)
    state = init_state(cfg, tcfg, device="cpu", params=params_from_reference(
        bf16_weights(arch), cfg, device="cpu"))
    step = make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size)
    losses, masks = [], []
    for k in range(steps):
        state, m = step(state, make_inputs(cfg, stream, k, BATCH, SEQ,
                                           device="cpu"))
        losses.append(float(m["loss"]))
        masks.append(tuple(m["comm_mask"].tolist()))
    return state, losses, tuple(masks)


def check_losses(losses, arch, algo, ref_bf, legacy=False):
    ref_32, _ = reference_run(arch, False, algo, len(ref_bf))
    assert np.all(np.isfinite(losses))
    got = np.max(np.abs(np.subtract(losses, ref_32)))
    own = np.max(np.abs(np.subtract(ref_bf, ref_32)))
    assert got <= ERR_RATIO * own, (arch, algo, legacy, losses, ref_bf,
                                    ref_32)


def check_state(state, cfg, algo):
    lo = param_layout(cfg)
    assert isinstance(lo, MixedLayout)
    theta = state["theta"]
    assert isinstance(theta, Parts)
    assert (theta.b.dtype, theta.f.dtype) == (torch.bfloat16, torch.float32)
    for leaf, dt in zip(tree_leaves(params_of(state, cfg)), lo.dtypes):
        part = theta.b if dt == torch.bfloat16 else theta.f
        assert leaf.dtype == dt
        assert leaf.untyped_storage().data_ptr() \
            == part.untyped_storage().data_ptr()
    for k in ("grad_hat", "nabla"):
        v = state["lag"][k]
        assert (v.b.dtype, v.f.dtype) == (torch.bfloat16, torch.float32), k
    if "laq" in algo:
        r = state["lag"]["resid"]
        assert r.b.dtype == r.f.dtype == torch.float32


@pytest.mark.parametrize("algo", ["lag-wk", "laq@4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_tree_trains_like_the_reference(arch, algo):
    """The plane and the plain route: masks equal to the reference's,
    losses within ERR_RATIO × its own bfloat16 error (module docstring)."""
    ref_bf, ref_masks = reference_run(arch, True, algo, STEPS)
    assert ref_bf, "the reference ran no round"
    cfg = get_config(arch).reduced(**BF16)
    runs = {}
    for mode in ("on", "auto"):
        state, losses, masks = port_run(arch, TrainerConfig(
            algo=algo, num_workers=TW, lr=0.3, fastpath=mode), len(ref_bf))
        assert masks == ref_masks, (mode, masks, ref_masks)
        check_losses(losses, arch, algo, ref_bf)
        check_state(state, cfg, algo)
        runs[mode] = (state, losses)
    if algo == "lag-wk":           # the same arithmetic on both routes
        assert runs["on"][1] == runs["auto"][1]
        for a, b in zip(runs["on"][0]["theta"], runs["auto"][0]["theta"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_route_trains_a_mixed_tree_like_the_reference(arch):
    """``use_pallas_comm=True``: every leaf's kernels at its own dtypes,
    masks equal to the reference's ``use_pallas_comm=True`` run, losses
    within ERR_RATIO × its own bfloat16 error."""
    ref_bf, ref_masks = reference_run(arch, True, "lag-wk", STEPS,
                                      legacy=True)
    state, losses, masks = port_run(arch, TrainerConfig(
        algo="lag-wk", num_workers=TW, lr=0.3, use_pallas_comm=True),
        len(ref_bf))
    assert masks == ref_masks
    check_losses(losses, arch, "lag-wk", ref_bf, legacy=True)
    check_state(state, get_config(arch).reduced(**BF16), "lag-wk")


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_state_is_about_half_the_float32_bytes(arch):
    """θ, ∇ and the mirrors of the bfloat16 config take about half the
    float32 config's bytes: the float32 part is small (≤ 1.1 ×)."""
    kw = dict(algo="lag-ps", num_workers=TW, lr=0.3)
    cfg = get_config(arch).reduced()
    s32 = init_state(cfg, TrainerConfig(**kw), device="cpu")
    s16 = init_state(cfg.replace(**BF16), TrainerConfig(**kw), device="cpu")
    nb = lambda v: sum(t.nbytes for t in tree_leaves(v))
    for k in ("grad_hat", "theta_hat", "nabla"):
        a, b = nb(s16["lag"][k]), nb(s32["lag"][k])
        assert b / 2 <= a <= 1.1 * b / 2, (k, a, b)
    assert nb(s16["theta"]) <= 1.1 * nb(s32["theta"]) / 2
