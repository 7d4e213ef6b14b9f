"""bfloat16 training on the ``pods``, ``async`` and ``fleet`` topologies,
against the LIVE JAX reference.

The reduced llama3.2-1b in bfloat16 (every leaf bfloat16), W = 2, batch
4 × 16, 3 rounds, from the reference's bfloat16 ``init_state`` weights:
the port's trainer on the plane (``fastpath="on"``: the kernels' plain
versions) and on the plain route (``"auto"``) against the reference's
jitted step on ``pods:2``, ``async:2@1`` and ``fleet:4@2``
(``FleetTopology(4, 2)`` with the reference's draws injected, uniform,
and ``innovation`` with churn 0.25), lr 0.3 on a fresh batch a round
(``make_inputs``, as ``test_torch_bf16_train.py`` trains shards); and
``pods:2`` at lr 0.005 on one fixed heterogeneous batch, where rounds 1
and 2 are quiet and the pods skip the reduction.

Tolerances, as ``test_torch_bf16_train.py`` holds shards: masks, cohorts
and the pods' skip count equal; losses within ``ERR_RATIO`` (2) × the
reference's own bfloat16 error against its float32 run on the widened
weights (the largest over the rounds); the plane and the plain route
bitwise equal.  The state: a bfloat16 ring takes half the float32 ring's
bytes (a ``Parts`` of rings for a mixed tree), the fleet's compact
mirrors are float32 rows of the reference's ``FlatLayout.for_tree``
width.  The gossip graph is the one topology that refuses bfloat16, by
name.  ``test_torch_bf16_topology_rounds.py`` holds each topology's round
alone, mamba2's mixed tree, ``grad_hat_dtype`` and the port's own
identities (laq@4 included: the reference's does not run on pods and the
fleet at bfloat16, ROADMAP queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.configs import get_config as jget_config
from repro.data import TokenStream as JTokenStream
from repro.data import make_heterogeneous_inputs as jmake_hetero
from repro.data import make_inputs as jmake_inputs
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import make_train_step as jmake_train_step
from repro.engine.topology import make_topology as jmake_topology
from repro.fastpath.layout import FlatLayout as JFlatLayout

from repro_torch import fleet
from repro_torch.configs import get_config
from repro_torch.data import (TokenStream, make_heterogeneous_inputs,
                              make_inputs)
from repro_torch.dist import pod_lag
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.engine import Experiment, make_topology
from repro_torch.fastpath.layout import Parts, parts_of
from repro_torch.fleet import FleetTopology
from repro_torch.fleet.population import MIRROR_PREFIX
from repro_torch.graph import init_graph_state
from repro_torch.weights import params_from_reference

from test_torch_fleet import deep_draw

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
#: the port's bfloat16 loss error against the reference's float32 run, as
#: a multiple of the reference's own bfloat16 error (test_torch_bf16.py)
ERR_RATIO = 2.0
LOSS_RTOL = 1e-4
W, BATCH, SEQ, STEPS = 2, 4, 16, 3
LR = 0.3
#: pods on one fixed batch: lr 0.005 makes rounds 1 and 2 quiet for both
#: pods in bfloat16 (found on the CPU: masks [1,1], [0,0], [0,0])
QUIET_LR = 0.005
#: (topology, fleet churn, fleet selection, lr, one fixed batch)
CASES = [("pods:2", 0.0, "uniform", LR, False),
         ("async:2@1", 0.0, "uniform", LR, False),
         ("fleet:4@2", 0.0, "uniform", LR, False),
         ("fleet:4@2", 0.25, "innovation", LR, False)]
CASE_IDS = ["pods", "async", "fleet", "fleet-innov-churn"]
QUIET_PODS = ("pods:2", 0.0, "uniform", QUIET_LR, True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its rounds are many small
    ops, which several test processes' thread pools slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def bf16_weights(arch):
    """The reference's bfloat16 init (its ``init_state``), as numpy."""
    st = jinit_state(jax.random.PRNGKey(0), jget_config(arch).reduced(**BF16),
                     JTrainerConfig(algo="gd", num_workers=W))
    return jax.tree_util.tree_map(np.asarray, st["params"])


def ref_cfg(arch, bf16):
    return jget_config(arch).reduced(**BF16) if bf16 \
        else jget_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def reference_run(arch, spec, churn, rule, lr, fixed, algo, bf16,
                  grad_hat_dtype=None):
    """STEPS rounds of the reference's jitted step on topology ``spec``
    from the bfloat16 weights (widened for the float32 config), on one
    fixed heterogeneous batch or a fresh batch a round: losses, masks,
    (cohorts, cohort masks) of a fleet, rounds skipped of pods."""
    jcfg = ref_cfg(arch, bf16)
    params = bf16_weights(arch)
    if not bf16:
        params = jax.tree_util.tree_map(lambda x: x.astype(np.float32),
                                        params)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    name = spec.split(":")[0]
    jt = JTrainerConfig(algo=algo, num_workers=W, lr=lr,
                        grad_hat_dtype=grad_hat_dtype)
    if name == "fleet":
        topo = jfleet.FleetTopology(4, 2, churn=churn, selection=rule)
        st = jfleet.init_fleet_state(jax.random.PRNGKey(0), jcfg, jt, topo)
        step = jax.jit(jfleet.make_fleet_step(jcfg, jt, topo))
    else:
        topo = jmake_topology(spec)
        st = jinit_state(jax.random.PRNGKey(0), jcfg, jt, topology=topo)
        step = jax.jit(jmake_train_step(jcfg, jt, topology=topo))
    st["params"] = params
    if name == "async":                 # the ring holds the new weights
        st["lag"].update(topo.extra_state(params))
    stream = JTokenStream(jcfg.vocab_size)
    fixed = jmake_hetero(jcfg, stream, 0, W, BATCH, SEQ) if fixed else None
    losses, masks, cohorts = [], [], []
    for k in range(STEPS):
        st, m = step(st, fixed if fixed is not None
                     else jmake_inputs(jcfg, stream, k, BATCH, SEQ))
        losses.append(float(m["loss"]))
        masks.append(np.asarray(m["comm_mask"]).tolist())
        if name == "fleet":
            cohorts.append((np.asarray(m["cohort_ids"]).tolist(),
                            np.asarray(m["cohort_comm"]).tolist()))
    skipped = st["lag"].get("rounds_skipped")
    return (tuple(losses), masks, cohorts,
            None if skipped is None else int(skipped))


def port_topology(spec, churn, rule):
    if spec.startswith("fleet"):
        return FleetTopology(4, 2, churn=churn, selection=rule,
                             draw=deep_draw(0, 4))
    return make_topology(spec)


def port_run(arch, spec, churn, rule, lr, fixed, algo, fastpath, bf16=True,
             grad_hat_dtype=None):
    """STEPS rounds of the port: (losses, masks, cohorts, state, topo)."""
    cfg = get_config(arch).reduced(**BF16) if bf16 \
        else get_config(arch).reduced()
    params = bf16_weights(arch)
    if not bf16:
        params = jax.tree_util.tree_map(lambda x: x.astype(np.float32),
                                        params)
    params = params_from_reference(params, cfg, device="cpu")
    name = spec.split(":")[0]
    tcfg = TrainerConfig(algo=algo, num_workers=W, lr=lr,
                         fastpath=fastpath, grad_hat_dtype=grad_hat_dtype)
    topo = port_topology(spec, churn, rule)
    if name == "fleet":
        st = fleet.init_fleet_state(cfg, tcfg, topo, device="cpu",
                                    params=params)
        step = fleet.make_fleet_step(cfg, tcfg, topo)
    else:
        st = init_state(cfg, tcfg, device="cpu", params=params,
                        topology=topo)
        step = make_train_step(cfg, tcfg, topology=topo)
    stream = TokenStream(cfg.vocab_size)
    fixed = make_heterogeneous_inputs(cfg, stream, 0, W, BATCH, SEQ,
                                      device="cpu") if fixed else None
    losses, masks, cohorts = [], [], []
    for k in range(STEPS):
        st, m = step(st, fixed if fixed is not None else make_inputs(
            cfg, stream, k, BATCH, SEQ, device="cpu"))
        losses.append(float(m["loss"]))
        masks.append(m["comm_mask"].tolist())
        if name == "fleet":
            cohorts.append((m["cohort_ids"].tolist(),
                            m["cohort_comm"].tolist()))
    return tuple(losses), masks, cohorts, st, topo


def check_against_reference(arch, case, algo):
    """The port on both routes against the reference's bfloat16 and
    float32 runs of ``case``; returns the reference's rounds skipped."""
    ref_bf, ref_masks, ref_cohorts, ref_skipped = reference_run(
        arch, *case, algo, True)
    ref_32 = reference_run(arch, *case, algo, False)[0]
    own = np.max(np.abs(np.subtract(ref_bf, ref_32)))
    runs = {}
    for fastpath in ("on", "auto"):
        losses, masks, cohorts, st, topo = port_run(arch, *case, algo,
                                                    fastpath)
        assert masks == ref_masks, (fastpath, masks, ref_masks)
        assert cohorts == ref_cohorts, (fastpath, cohorts, ref_cohorts)
        assert np.all(np.isfinite(losses))
        got = np.max(np.abs(np.subtract(losses, ref_32)))
        assert got <= ERR_RATIO * own, (fastpath, losses, ref_bf, ref_32)
        if ref_skipped is not None:
            assert int(st["lag"]["rounds_skipped"]) == ref_skipped \
                == topo.branches["zero"]
        runs[fastpath] = (losses, st)
    # the plane and the plain route do the same arithmetic
    assert runs["on"][0] == runs["auto"][0]
    for a, b in zip(parts_of(runs["on"][1]["theta"]),
                    parts_of(runs["auto"][1]["theta"])):
        assert torch.equal(a, b)
    return ref_skipped


@pytest.mark.parametrize("algo", ["lag-wk", "lag-ps"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bf16_topology_trains_like_the_reference(case, algo):
    """The all-bfloat16 llama: masks (and a fleet's cohorts and cohort
    masks) equal to the reference's, losses within ERR_RATIO × its own
    bfloat16 error, on the plane and the plain route."""
    check_against_reference("llama3.2-1b", case, algo)


def test_bf16_pods_skip_quiet_rounds_like_the_reference():
    """lag-wk on one fixed batch at lr 0.005: rounds 1 and 2 are quiet,
    the pods' zero branch runs (zeros at bfloat16), the skip count and
    everything above equal the reference's."""
    assert check_against_reference("llama3.2-1b", QUIET_PODS, "lag-wk") == 2


def test_bf16_state_dtypes_and_bytes():
    """A bfloat16 async ring is half the float32 one (a ``Parts`` of rings
    for a mixed tree, each at its part's dtype); the fleet's compact
    mirrors are float32 rows as wide as the reference's
    ``FlatLayout.for_tree`` of the parameters, whatever the tree."""
    tcfg = TrainerConfig(algo="lag-ps", num_workers=W, lr=0.3)
    cfg = get_config("llama3.2-1b").reduced()
    ring = lambda c: init_state(c, tcfg, device="cpu",
                                topology=make_topology("async:2@1"))[
        "lag"]["theta_ring"]
    r32, r16 = ring(cfg), ring(cfg.replace(**BF16))
    assert r16.dtype == torch.bfloat16 and r32.dtype == torch.float32
    assert r16.shape == r32.shape and 2 * r16.nbytes == r32.nbytes
    mixed = ring(get_config("mamba2-370m").reduced(**BF16))
    assert isinstance(mixed, Parts)
    assert (mixed.b.dtype, mixed.f.dtype) == (torch.bfloat16, torch.float32)
    assert mixed.b.shape[0] == mixed.f.shape[0] == 2
    for arch in ("llama3.2-1b", "mamba2-370m"):
        c = get_config(arch).reduced(**BF16)
        st = fleet.init_fleet_state(c, tcfg, make_topology("fleet:4@2"),
                                    device="cpu")
        cols = JFlatLayout.for_tree(jax.tree_util.tree_map(
            jnp.asarray, bf16_weights(arch))).packed_cols
        for key in ("grad_hat", "theta_hat"):
            mir = st["lag"][MIRROR_PREFIX + key]
            assert mir.dtype == torch.float32 and mir.shape == (4, cols)


def test_pods_shim_and_experiment_front_door_at_bf16():
    """``dist/pod_lag.py``'s shim and ``Experiment(model=<a bfloat16
    ModelConfig>)`` run pods, async and the fleet: the shim's masks are
    the trainer's, every report's losses finite."""
    cfg = get_config("llama3.2-1b").reduced(**BF16)
    params = params_from_reference(bf16_weights("llama3.2-1b"), cfg,
                                   device="cpu")
    tcfg = TrainerConfig(algo="lag-wk", num_workers=4, lr=QUIET_LR,
                         fastpath="on")
    st = pod_lag.init_state(cfg, tcfg, 2, device="cpu", params=params)
    step = pod_lag.make_pod_lag_step(cfg, tcfg)
    batch = make_heterogeneous_inputs(cfg, TokenStream(cfg.vocab_size), 0,
                                      W, BATCH, SEQ, device="cpu")
    masks = []
    for _ in range(STEPS):
        st, m = step(st, batch)
        masks.append(m["comm_mask"].tolist())
    assert masks == port_run("llama3.2-1b", *QUIET_PODS, "lag-wk",
                             "on")[1]
    for spec in ("pods:2", "async:2@1", "fleet:4@2"):
        r = Experiment(model=cfg, topology=spec, algo="lag-wk", steps=2,
                       lr=0.3, workers=2, batch=BATCH, seq=SEQ,
                       device="cpu").run()
        assert np.isfinite(r.losses).all() and r.losses.shape == (2,)


def test_graph_refuses_bf16_by_name():
    """The one topology the port does not train at bfloat16: the
    reference's deep graph step does not trace a bfloat16 tree."""
    cfg = get_config("llama3.2-1b").reduced(**BF16)
    topo = make_topology("graph:2@complete")
    for c, kw in ((cfg, {}), (get_config("llama3.2-1b").reduced(),
                              {"grad_hat_dtype": "bfloat16"})):
        with pytest.raises(NotImplementedError,
                           match=r"graph/rounds\.py:299"):
            init_graph_state(c, TrainerConfig(algo="lag-wk", num_workers=2,
                                              **kw), topo, device="cpu")
    with pytest.raises(NotImplementedError, match="graph topology"):
        Experiment(model=cfg, topology="graph:2@complete", steps=1,
                   workers=2, batch=BATCH, seq=SEQ, device="cpu").run()
