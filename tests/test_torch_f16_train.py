"""float16 training: the port's round and trainer against the LIVE JAX
reference with float16 trees.

The round alone (W = 3, the plain-version plane ``fastpath="on"`` and the
plain per-leaf route ``"auto"``; lag-wk and lag-ps): float16 gradients,
mirrors and θ from numpy seeds (``test_torch_bf16_train.make_round_inputs``
at float16) go through the port's ``engine.rounds.lag_round`` and the
reference's jitted oracle route.  Masks, ĝ, θ̂ and ∇ (the sum of three
float16 workers in float32, rounded once, as XLA reduces it) are equal bit
for bit; θ within half a float16 ulp of the step α·∇ and one of θ (XLA-CPU
fuses θ − α·∇ at float16 without rounding the product, ROADMAP queue 3);
θ and every state buffer are float16 (before this port slice a float16
tree trained in float32 buffers, and this test failed on that).

Then the trainer, reduced llama3.2-1b, W = 2, batch 4 × 16:

- float16 lag-wk, 3 rounds, against the reference's jitted ``make_train_step``
  from the same weights and batches: masks equal, losses within 3× the
  reference's own float16 error against its float32 run on the widened
  weights (the largest over the rounds, as ``test_torch_bf16_train``;
  ``ERR_RATIO`` says why 3), θ a float16 buffer whose leaves are views of
  it;
- the float32 model with ``grad_hat_dtype="float16"``, 3 rounds of lag-wk
  on both routes: masks equal, losses within rtol 1e-4 (the float32
  trainer tests'), ĝ float16;
- mamba2-370m's tree of float16 and float32 leaves, one round: masks equal,
  the loss within 3× the reference's own error, θ two parts;
- laq@4: the reference's float16 step promotes θ to float32 in round 0
  and fails in round 1 (ROADMAP queue 3), so the port is held to its own
  identities: the plane, the legacy and the
  plain route give equal masks, and losses within the plane-vs-plain
  readings of ``chip_smoke.F16_ROUTE_LOSS_READINGS`` × 2 (one rounding of
  the float32 payload into the float16 ĝ on the plane, two elsewhere);
- pods:2, async:2@0 and fleet:2@2 at float16: bit for bit the shards run
  (no reference jit);
- a float16 checkpoint: numpy's own float16 entry, read back by the
  reference's ``restore``;
- the gossip graph refuses a float16 tree by name: the reference's deep
  graph step promotes it to float32 in round 0 and fails in round 1.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.checkpoint import store as jstore
from repro.configs import get_config as jget_config
from repro.data import TokenStream as JTokenStream
from repro.data import make_inputs as jmake_inputs
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import make_train_step as jmake_train_step
from repro.engine.topology import make_topology as jmake_topology

from repro_torch import fleet, graph
from repro_torch.checkpoint import save
from repro_torch.configs import get_config
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist import lag_trainer
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step, params_of)
from repro_torch.engine import make_topology
from repro_torch.fastpath.layout import Parts
from repro_torch.weights import params_from_reference

from test_torch_bf16_train import (bitwise, flat, make_round_inputs,
                                   run_port, run_reference)

F16 = dict(dtype="float16", param_dtype="float16")
H = np.float16
BATCH, SEQ, STEPS, TW = 4, 16, 3, 2
#: the port's float16 loss error against the reference's float32 run, as a
#: multiple of the reference's own float16 error.  bfloat16's is 2; in
#: float16 XLA-CPU keeps the attention scores and other float16
#: intermediates in float32 where the program rounds them (its excess
#: precision, ROADMAP queue 3), which makes the reference's own float16
#: error smaller: the port's measured 2.1× it (3 rounds of lag-wk)
ERR_RATIO = 3.0
#: LAQ's routes at float16: the plane folds the float32 payload into ĝ
#: with one rounding, the legacy and plain routes with two; 2 × the
#: largest |Δ loss| the card read over 4 rounds at full width
#: (chip_smoke.F16_ROUTE_LOSS_READINGS) bounds the reduced model's 2 rounds
LAQ_ROUTE_BOUND = 2 * 1.431e-05


def f16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One float16 ulp at |x| (11 significant bits; 2^-24 below 2^-14)."""
    _, e = torch.frexp(x.double().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                       torch.clamp(e, min=-13) - 11)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its rounds are many small
    ops, which several test processes' thread pools slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The round alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("spec", ["lag-wk", "lag-ps"])
def test_f16_round_matches_reference(spec, mode):
    """One round at float16 on both routes against the reference's oracle
    route: masks, ĝ, θ̂, ∇ and θ bitwise, all in float16 buffers."""
    inputs = make_round_inputs(spec, pdt=H, ghdt=H)
    jtheta, _, jls, jm = run_reference(spec, "sgd", "auto", inputs)
    h = torch.float16
    lo, (theta, _, ls, m) = run_port(spec, "sgd", mode, inputs, pdt=h,
                                     ghdt=h)
    np.testing.assert_array_equal(m["comm_mask"].numpy(), jm["comm_mask"])
    if spec == "lag-wk":                      # a lazy worker in between
        assert m["comm_mask"].tolist() == [True, False, True]
    assert theta.dtype == ls["nabla"].dtype == ls["grad_hat"].dtype == h
    bitwise(ls["grad_hat"], flat(lo, jls["grad_hat"], True, h), "grad_hat")
    if "theta_hat" in ls:
        assert ls["theta_hat"].dtype == h
        bitwise(ls["theta_hat"], flat(lo, jls["theta_hat"], True, h),
                "theta_hat")
    jn = flat(lo, jls["nabla"], False, h)
    bitwise(ls["nabla"], jn, "nabla")
    # XLA-CPU computes θ − α·∇ at float16 with one rounding (ROADMAP queue
    # 3); the port rounds the product α·∇ to float16 first, as it does at
    # bfloat16, where XLA does too: within half an ulp of the product and
    # one of θ
    jt = flat(lo, jtheta, False, h).double()
    step = lag.weak(0.1, h) * jn.double()
    d = (theta.double() - jt).abs()
    assert torch.all(d <= f16_ulp(step) / 2 + f16_ulp(jt)), float(d.max())


# ---------------------------------------------------------------------------
# The trainer on a reduced float16 llama
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def f16_weights(arch):
    """The reference's float16 init (its ``init_state``), as numpy."""
    st = jinit_state(jax.random.PRNGKey(0), jget_config(arch).reduced(**F16),
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


def port_run(cfg, tcfg, params, steps, topology=None):
    if topology is not None and topology.startswith("fleet"):
        topo = fleet.FleetTopology(TW, TW)
        state = fleet.init_fleet_state(cfg, tcfg, topo, device="cpu",
                                       params=params)
        step = fleet.make_fleet_step(cfg, tcfg, topo)
    else:
        topo = None if topology is None else make_topology(topology)
        state = init_state(cfg, tcfg, device="cpu", params=params,
                           topology=topo)
        step = make_train_step(cfg, tcfg, topology=topo)
    stream = TokenStream(cfg.vocab_size)
    losses, masks = [], []
    for k in range(steps):
        state, m = step(state, make_inputs(cfg, stream, k, BATCH, SEQ,
                                           device="cpu"))
        losses.append(float(m["loss"]))
        masks.append(m["comm_mask"].tolist())
    return state, losses, masks


def within_own_error(arch, algo, steps, losses, masks):
    """The port's losses against the reference's float16 run and its float32
    run on the widened weights."""
    kw = dict(algo=algo, num_workers=TW, lr=0.3)
    w = f16_weights(arch)
    ref_h, ref_masks = reference_run(jget_config(arch).reduced(**F16),
                                     JTrainerConfig(**kw), w, steps)
    wide = jax.tree_util.tree_map(lambda x: x.astype(np.float32), w)
    ref_32, _ = reference_run(jget_config(arch).reduced(),
                              JTrainerConfig(**kw), wide, steps)
    assert masks == ref_masks
    assert np.all(np.isfinite(losses))
    got = np.max(np.abs(np.subtract(losses, ref_32)))
    own = np.max(np.abs(np.subtract(ref_h, ref_32)))
    assert got <= ERR_RATIO * own, (losses, ref_h, ref_32)


def test_f16_trainer_matches_live_reference():
    """3 rounds of lag-wk on the plane: masks equal, losses within
    ERR_RATIO × the reference's own float16 error; θ, ∇ and ĝ are float16
    buffers, the parameters views of θ, holding only float16 values."""
    cfg = get_config("llama3.2-1b").reduced(**F16)
    params = params_from_reference(f16_weights("llama3.2-1b"), cfg,
                                   device="cpu")
    state, losses, masks = port_run(cfg, TrainerConfig(
        algo="lag-wk", num_workers=TW, lr=0.3, fastpath="on"), params, STEPS)
    within_own_error("llama3.2-1b", "lag-wk", STEPS, losses, masks)
    theta = state["theta"]
    assert theta.dtype == torch.float16
    assert all(l.dtype == torch.float16 and l.untyped_storage().data_ptr()
               == theta.untyped_storage().data_ptr()
               for l in tree_leaves(params_of(state, cfg)))
    for k in ("grad_hat", "nabla"):
        assert state["lag"][k].dtype == torch.float16, k


def test_float32_model_with_f16_grad_hat_matches_live_reference():
    """``grad_hat_dtype="float16"`` on the float32 model, 3 rounds of
    lag-wk on both routes: masks equal, losses within rtol 1e-4."""
    kw = dict(algo="lag-wk", num_workers=TW, lr=0.3,
              grad_hat_dtype="float16")
    jcfg = jget_config("llama3.2-1b").reduced()
    st = jinit_state(jax.random.PRNGKey(0), jcfg, JTrainerConfig(**kw))
    params = jax.tree_util.tree_map(np.asarray, st["params"])
    ref, ref_masks = reference_run(jcfg, JTrainerConfig(**kw), params, STEPS)
    cfg = get_config("llama3.2-1b").reduced()
    for mode in ("auto", "on"):
        state, losses, masks = port_run(
            cfg, TrainerConfig(**kw, fastpath=mode),
            params_from_reference(params, cfg, device="cpu"), STEPS)
        assert masks == ref_masks
        np.testing.assert_allclose(losses, ref, rtol=1e-4)
        assert state["lag"]["grad_hat"].dtype == torch.float16
        assert state["theta"].dtype == torch.float32


def test_mamba2_f16_mixed_tree_round_matches_live_reference():
    """mamba2-370m at float16 keeps float32 leaves: θ is a pair of parts
    (float16, float32), and its round matches the reference's."""
    cfg = get_config("mamba2-370m").reduced(**F16)
    params = params_from_reference(f16_weights("mamba2-370m"), cfg,
                                   device="cpu")
    state, losses, masks = port_run(cfg, TrainerConfig(
        algo="lag-wk", num_workers=TW, lr=0.3, fastpath="on"), params, 1)
    within_own_error("mamba2-370m", "lag-wk", 1, losses, masks)
    theta = state["theta"]
    assert isinstance(theta, Parts)
    assert (theta.b.dtype, theta.f.dtype) == (torch.float16, torch.float32)


def test_laq_at_f16_holds_the_ports_identities():
    """The reference's laq@4 step promotes a float16 tree to float32 in
    round 0 (its float32 payload) and fails on the scan carry in round 1;
    the port's plane, legacy and plain routes agree: masks equal, losses
    within LAQ_ROUTE_BOUND, ĝ float16 and the residual float32 on each."""
    jcfg = jget_config("llama3.2-1b").reduced(**F16)
    jt = JTrainerConfig(algo="laq@4", num_workers=TW, lr=0.3)
    st = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    step = jax.jit(jmake_train_step(jcfg, jt))
    stream = JTokenStream(jcfg.vocab_size)
    st, _ = step(st, jmake_inputs(jcfg, stream, 0, BATCH, SEQ))
    assert {str(l.dtype) for l in jax.tree_util.tree_leaves(
        st["params"])} == {"float32"}         # promoted by the payload
    with pytest.raises(TypeError, match="carry"):
        step(st, jmake_inputs(jcfg, stream, 1, BATCH, SEQ))
    cfg = get_config("llama3.2-1b").reduced(**F16)
    params = params_from_reference(f16_weights("llama3.2-1b"), cfg,
                                   device="cpu")
    runs = {}
    for route, kw in (("plane", dict(fastpath="on")),
                      ("legacy", dict(use_pallas_comm=True)),
                      ("plain", {})):
        state, losses, masks = port_run(cfg, TrainerConfig(
            algo="laq@4", num_workers=TW, lr=0.3, **kw), params, 2)
        assert state["lag"]["grad_hat"].dtype == torch.float16
        assert state["lag"]["resid"].dtype == torch.float32
        assert np.all(np.isfinite(losses))
        runs[route] = (losses, masks)
    for route in ("legacy", "plain"):
        assert runs[route][1] == runs["plane"][1]
        assert np.max(np.abs(np.subtract(runs[route][0], runs["plane"][0]))
                      ) <= LAQ_ROUTE_BOUND


@pytest.mark.parametrize("topology", ["pods:2", "async:2@0", "fleet:2@2"])
def test_f16_topologies_are_bitwise_the_shards_run(topology):
    """pods:2 (no quiet round here), async:2@0 and the full-cohort fleet
    are the shards run bit for bit at float16: losses, masks and θ."""
    cfg = get_config("llama3.2-1b").reduced(**F16)
    tcfg = TrainerConfig(algo="lag-wk", num_workers=TW, lr=0.3,
                         fastpath="on")
    params = params_from_reference(f16_weights("llama3.2-1b"), cfg,
                                   device="cpu")
    shards = port_run(cfg, tcfg, params, STEPS)
    state, losses, masks = port_run(cfg, tcfg, params, STEPS, topology)
    assert losses == shards[1] and masks == shards[2]
    assert state["theta"].dtype == torch.float16
    assert torch.equal(state["theta"], shards[0]["theta"])


def test_f16_checkpoint_is_read_by_the_references_restore(tmp_path):
    """A float16 state buffer is numpy's own float16 entry: the reference's
    ``restore`` reads the port's file bit for bit."""
    cfg = get_config("llama3.2-1b").reduced(**F16)
    st = init_state(cfg, TrainerConfig(algo="lag-wk", num_workers=TW),
                    device="cpu", seed=3)
    save(str(tmp_path), 1, {"theta": st["theta"],
                            "grad_hat": st["lag"]["grad_hat"]})
    like = {"theta": jnp.zeros(tuple(st["theta"].shape), jnp.float16),
            "grad_hat": jnp.zeros(tuple(st["lag"]["grad_hat"].shape),
                                  jnp.float16)}
    got, step = jstore.restore(str(tmp_path), like)
    assert step == 1
    for k in like:
        want = (st["theta"] if k == "theta" else st["lag"][k]).numpy()
        arr = np.asarray(got[k])
        assert arr.dtype == np.float16
        assert np.array_equal(arr.view(np.int16), want.view(np.int16))


def test_graph_refuses_f16_by_name():
    """The reference's deep graph step on a float16 tree: round 0 promotes
    the parameters to float32 (its float32 mixing weights), round 1 fails
    on the scan carry's dtype; its edge mirrors stay float32 whatever
    ``grad_hat_dtype`` says.  The port refuses, by name, the float16 tree
    and a float32 model with ``grad_hat_dtype="float16"``, as it refuses
    bfloat16's (``test_torch_bf16_topologies.py``)."""
    jcfg = jget_config("llama3.2-1b").reduced(**F16)
    jt = JTrainerConfig(algo="lag-wk", num_workers=2, lr=0.3)
    topo = jmake_topology("graph:2@complete")
    st = jgraph.init_graph_state(jax.random.PRNGKey(0), jcfg, jt, topo)
    step = jax.jit(jgraph.make_graph_step(jcfg, jt, topo))
    batch = jmake_inputs(jcfg, JTokenStream(jcfg.vocab_size), 0, BATCH, SEQ)
    st, _ = step(st, batch)
    assert {str(l.dtype) for l in jax.tree_util.tree_leaves(
        st["params"])} == {"float32"}
    with pytest.raises(TypeError, match="carry"):
        step(st, batch)
    jst = jgraph.init_graph_state(
        jax.random.PRNGKey(0), jget_config("llama3.2-1b").reduced(),
        jt.replace(grad_hat_dtype="float16"), topo)
    assert jst["lag"]["edge_grad_hat"].dtype == jnp.float32
    tcfg = TrainerConfig(algo="lag-wk", num_workers=2)
    for cfg, tc in ((get_config("llama3.2-1b").reduced(**F16), tcfg),
                    (get_config("llama3.2-1b").reduced(),
                     tcfg.replace(grad_hat_dtype="float16"))):
        with pytest.raises(NotImplementedError,
                           match=r"graph/rounds\.py:299"):
            lag_trainer.check_trainable(cfg, tc,
                                        make_topology("graph:2@complete"))


def test_dryrun_reckons_a_float16_config():
    """The one-card dry-run reckons a float16 config (float16 ĝ by default):
    its θ half the float32 config's bytes, its peak under the float32
    one's."""
    from repro_torch.launch import dryrun
    recs = {dt: dryrun.reckon(dryrun.dryrun_config("llama3.2-1b", dt)
                              .reduced(), "train_4k", TW, batch=BATCH,
                              seq=SEQ)
            for dt in ("float16", "float32")}
    h, f = (recs[dt]["memory"] for dt in ("float16", "float32"))
    assert 2 * h["state_bytes"]["theta"] == f["state_bytes"]["theta"] > 0
    assert 0 < h["peak_bytes"] < f["peak_bytes"]
