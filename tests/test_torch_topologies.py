"""The port's deep topologies (``pods``, ``async``), the topology grammar,
the deep heterogeneity dial and the deep front doors (``Experiment(model=
…)``, the launcher's ``--topology`` / ``--hetero`` / ``--cluster``), held
against the LIVE JAX reference.

Reduced llama3.2-1b, W = 2, 3 rounds on one fixed heterogeneous batch (the
``Experiment`` regime): the reference's jitted ``make_train_step`` with its
``AsyncShards`` / ``PodMesh`` (its own route on the CPU: the jnp oracle)
and the port's, from the same ``model.init`` parameters exported to numpy.
Losses within rtol 1e-4 and equal upload masks, on the port's batched plane
(``fastpath="on"``: the kernels' plain versions) and on its legacy per-leaf
route (``use_pallas_comm=True``).  ``async:W@0`` and ``pods:W`` are bitwise
the port's own ``shards``.  No golden file is used.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import TokenStream as JTokenStream
from repro.data import make_heterogeneous_inputs as jmake_hetero
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import make_train_step as jmake_train_step
from repro.engine.topology import make_topology as jmake_topology
from repro.netsim import hetero as jhetero

from repro_torch import data as data_lib
from repro_torch.configs import get_config
from repro_torch.data import TokenStream, make_heterogeneous_inputs
from repro_torch.dist import pod_lag
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.engine import Experiment
from repro_torch.engine.topology import (AsyncShards, BatchShards, PodMesh,
                                         make_topology)
from repro_torch.launch import train as launch_train
from repro_torch.netsim import hetero
from repro_torch.weights import params_from_reference

W, BATCH, SEQ, STEPS = 2, 4, 32, 3
LOSS_RTOL = 1e-4
# pods: lr 0.01 makes lag-wk's round 1 quiet for both pods (found on the
# CPU: masks [1,1], [0,0], [0,1]); lr 0.3 uploads every round
POD_LR, ASYNC_LR = 0.01, 0.3
ALGOS = ("lag-wk", "lag-ps", "laq@4")
ROUTES = {"plane": {"fastpath": "on"}, "legacy": {"use_pallas_comm": True}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its rounds are many small
    ops, which several test processes' thread pools slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# make_topology's grammar, case by case against the reference's
# ---------------------------------------------------------------------------

GOOD_SPECS = ("sim", "shards", "pods", "pods:2", "pods:3", "async",
              "async:4", "async:4@2", "async:2@0", "async@3", "fleet:4@2",
              "fleet:100000@64", "fleet:5@5", " pods:2")


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_make_topology_matches_reference(spec):
    got, want = make_topology(spec), jmake_topology(spec)
    assert got.name == want.name and got.kind == want.kind
    assert got.num_units == want.num_units
    assert got.units(7) == want.units(7)
    for attr in ("staleness", "population", "cohort", "churn", "selection"):
        assert getattr(got, attr, None) == getattr(want, attr, None)
    if spec.startswith("async"):
        for w in (1, 2, 3, 5):
            assert np.array_equal(got.stale_steps(w), want.stale_steps(w))
    assert make_topology(got) is got


BAD_SPECS = ("", 3, None, "bogus", "bogus:2", "fleet", "fleet:", "fleet:@",
             "fleet:64", "fleet:64@", "fleet:x@8", "fleet:64@y", "fleet:0@5",
             "fleet:8@0", "fleet:8@9", "pods:", "pods:0", "shards:x",
             "pods:2@1", "sim@2", "async:4@x", "async:4@-1", "async:x@1")


@pytest.mark.parametrize("spec", BAD_SPECS, ids=repr)
def test_make_topology_errors_match_reference(spec):
    with pytest.raises(ValueError) as got:
        make_topology(spec)
    with pytest.raises(ValueError) as want:
        jmake_topology(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["graph:9@ring", "devices:2", "devices",
                                  "graph"])
def test_graph_and_devices_are_not_ported_yet(spec):
    """Both are ported now: ``graph`` (the gossip slice) builds the
    reference's graph and rejects as the reference does; ``devices`` (the
    device plane) builds a ``DeviceWorkers`` with the reference's name and
    unit counts.  (The name is kept from when both raised, so that the
    test's history stays one.)"""
    if spec.startswith("devices"):
        got, want = make_topology(spec), jmake_topology(spec)
        assert type(got).__name__ == "DeviceWorkers"
        assert (got.name, got.num_units, got.num_devices(4), got.units(4)) \
            == (want.name, want.num_units, want.num_devices(4),
                want.units(4))
    elif spec == "graph":
        with pytest.raises(ValueError) as got:
            make_topology(spec)
        with pytest.raises(ValueError) as want:
            jmake_topology(spec)
        assert str(got.value) == str(want.value)
    else:
        got, want = make_topology(spec), jmake_topology(spec)
        assert (got.name, got.num_nodes, got.num_edges, got.units(2)) \
            == (want.name, want.num_nodes, want.num_edges, want.units(2))


# ---------------------------------------------------------------------------
# The deep heterogeneity dial: bitwise the reference's batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W_, h", [(1, 1.0), (2, 0.8), (4, 1.0), (5, 0.0),
                                   (9, 0.37)])
def test_shard_noise_levels_bitwise(W_, h):
    got = hetero.shard_noise_levels(W_, h)
    want = jhetero.shard_noise_levels(W_, h)
    assert bits_equal(np.asarray(got, np.float64), np.asarray(want,
                                                              np.float64))


@pytest.mark.parametrize("step, fixed, h", [(0, True, 1.0), (3, False, 0.8),
                                            (3, True, 0.0), (1, False, 0.5)])
def test_hetero_inputs_bitwise(step, fixed, h):
    jcfg, cfg = jget_config("llama3.2-1b").reduced(), \
        get_config("llama3.2-1b").reduced()
    want = jhetero.hetero_inputs(jcfg, JTokenStream(jcfg.vocab_size, seed=4),
                                 step, 4, 8, 16, h=h, fixed=fixed)
    got = hetero.hetero_inputs(cfg, TokenStream(cfg.vocab_size, seed=4),
                               step, 4, 8, 16, h=h, fixed=fixed,
                               device="cpu")
    wrap = make_heterogeneous_inputs(cfg, TokenStream(cfg.vocab_size,
                                                      seed=4), step, 4, 8,
                                     16, h=h, fixed=fixed, device="cpu")
    jwrap = jmake_hetero(jcfg, JTokenStream(jcfg.vocab_size, seed=4), step,
                         4, 8, 16, h=h, fixed=fixed)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        assert bits_equal(got[k].numpy(), np.asarray(want[k]))
        assert bits_equal(wrap[k].numpy(), np.asarray(jwrap[k]))


def test_hetero_dial_validates_like_the_reference():
    for h in (-0.1, 1.5):
        with pytest.raises(ValueError, match="must be in"):
            hetero.shard_noise_levels(2, h)
        with pytest.raises(ValueError, match="must be in"):
            jhetero.shard_noise_levels(2, h)


@pytest.mark.parametrize("fn", ["make_inputs", "make_heterogeneous_inputs",
                                "hetero_inputs"])
def test_data_path_needs_a_gpu_unless_asked_for_cpu(fn):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("llama3.2-1b").reduced()
    call = {"make_inputs": lambda **kw: data_lib.make_inputs(
                cfg, TokenStream(cfg.vocab_size), 0, 4, 8, **kw),
            "make_heterogeneous_inputs": lambda **kw:
                data_lib.make_heterogeneous_inputs(
                    cfg, TokenStream(cfg.vocab_size), 0, 2, 4, 8, **kw),
            "hetero_inputs": lambda **kw: hetero.hetero_inputs(
                cfg, TokenStream(cfg.vocab_size), 0, 2, 4, 8, **kw)}[fn]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert call(device="cpu")["tokens"].device.type == "cpu"


# ---------------------------------------------------------------------------
# The deep topologies against the reference and against shards
# ---------------------------------------------------------------------------

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


@pytest.fixture(scope="module")
def batches(cfgs):
    jcfg, cfg = cfgs
    jb = jmake_hetero(jcfg, JTokenStream(jcfg.vocab_size), 0, W, BATCH, SEQ)
    b = make_heterogeneous_inputs(cfg, TokenStream(cfg.vocab_size), 0, W,
                                  BATCH, SEQ, device="cpu")
    return jb, b


_REF = {}


def reference_run(cfgs, batches, spec, algo, lr):
    """STEPS rounds of the reference trainer on topology ``spec`` (cached
    per module: one jit each): losses, masks, rounds_skipped."""
    key = (spec, algo, lr)
    if key not in _REF:
        jcfg, _ = cfgs
        jt = JTrainerConfig(algo=algo, num_workers=W, lr=lr)
        topo = jmake_topology(spec)
        st = jinit_state(jax.random.PRNGKey(0), jcfg, jt, topology=topo)
        step = jax.jit(jmake_train_step(jcfg, jt, topology=topo))
        losses, masks = [], []
        for _ in range(STEPS):
            st, m = step(st, batches[0])
            losses.append(float(m["loss"]))
            masks.append(np.asarray(m["comm_mask"]).tolist())
        skipped = st["lag"].get("rounds_skipped")
        _REF[key] = (np.asarray(losses), masks,
                     None if skipped is None else int(skipped))
    return _REF[key]


def port_run(cfgs, ref_params, batches, topology, algo, lr, **route):
    """STEPS rounds of the port's trainer: losses, masks, the final state."""
    _, cfg = cfgs
    tcfg = TrainerConfig(algo=algo, num_workers=W, lr=lr, **route)
    topo = make_topology(topology)
    state = init_state(cfg, tcfg, device="cpu", topology=topo,
                       params=params_from_reference(
                           ref_params, cfg, device="cpu"))
    step = make_train_step(cfg, tcfg, topology=topo)
    losses, masks = [], []
    for _ in range(STEPS):
        state, m = step(state, batches[1])
        losses.append(float(m["loss"]))
        masks.append(m["comm_mask"].tolist())
    return np.asarray(losses), masks, state, topo


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("algo", ALGOS)
def test_async_matches_reference(cfgs, ref_params, batches, algo, route):
    want_l, want_m, _ = reference_run(cfgs, batches, "async:2@1", algo,
                                      ASYNC_LR)
    got_l, got_m, state, _ = port_run(cfgs, ref_params, batches,
                                      "async:2@1", algo, ASYNC_LR,
                                      **ROUTES[route])
    assert got_m == want_m
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)
    # the ring holds θ^k and θ^{k−1}: slot 0 is the server's θ
    ring = state["lag"]["theta_ring"]
    assert ring.shape == (2,) + tuple(state["theta"].shape)
    assert torch.equal(ring[0], state["theta"])
    assert not torch.equal(ring[1], ring[0])


@pytest.mark.parametrize("route", ["plane", "plain", "legacy"])
@pytest.mark.parametrize("algo", ALGOS)
def test_async_staleness0_is_bitwise_shards(cfgs, ref_params, batches, algo,
                                            route):
    kw = {"plane": {"fastpath": "on"}, "plain": {},
          "legacy": {"use_pallas_comm": True}}[route]
    a_l, a_m, a_st, _ = port_run(cfgs, ref_params, batches, f"async:{W}@0",
                                 algo, ASYNC_LR, **kw)
    s_l, s_m, s_st, _ = port_run(cfgs, ref_params, batches, "shards", algo,
                                 ASYNC_LR, **kw)
    assert a_m == s_m and bits_equal(a_l, s_l)
    assert torch.equal(a_st["theta"], s_st["theta"])
    for k, v in s_st["lag"].items():
        assert torch.equal(a_st["lag"][k], v), k


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("algo", ALGOS)
def test_pods_match_reference(cfgs, ref_params, batches, algo, route):
    want_l, want_m, want_skip = reference_run(cfgs, batches, "pods:2", algo,
                                              POD_LR)
    got_l, got_m, state, topo = port_run(cfgs, ref_params, batches,
                                         "pods:2", algo, POD_LR,
                                         **ROUTES[route])
    assert got_m == want_m
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)
    skipped = int(state["lag"]["rounds_skipped"])
    assert skipped == want_skip
    quiet = sum(not any(m) for m in got_m)
    assert topo.branches == {"sum": STEPS - quiet, "zero": quiet}
    assert skipped == quiet
    if algo == "lag-wk":
        # the setting this test was chosen for: round 1 is quiet
        assert got_m[1] == [False, False] and topo.branches["zero"] == 1


@pytest.mark.parametrize("algo", ALGOS)
def test_pods_are_bitwise_shards(cfgs, ref_params, batches, algo):
    p_l, p_m, p_st, topo = port_run(cfgs, ref_params, batches, "pods:2",
                                    algo, POD_LR, fastpath="on")
    s_l, s_m, s_st, _ = port_run(cfgs, ref_params, batches, "shards", algo,
                                 POD_LR, fastpath="on")
    assert p_m == s_m and bits_equal(p_l, s_l)
    assert torch.equal(p_st["theta"], s_st["theta"])
    assert int(p_st["lag"]["rounds_skipped"]) == topo.branches["zero"]


def test_pod_zero_branch_is_the_deltas_dtype_and_device():
    red = PodMesh(num_units=2).reduce_fn()
    delta = torch.ones((2, 8, 128), dtype=torch.float64)
    out = red(torch.zeros(2, dtype=torch.bool), delta)
    assert out.dtype == torch.float64 and out.shape == (8, 128)
    assert not out.any()
    out = red(torch.tensor([False, True]), delta)
    assert torch.equal(out, torch.full((8, 128), 2.0, dtype=torch.float64))


def test_pod_lag_shim(cfgs, ref_params, batches):
    _, cfg = cfgs
    tcfg = TrainerConfig(algo="lag-wk", num_workers=4, lr=POD_LR,
                         fastpath="on")
    state = pod_lag.init_state(cfg, tcfg, 2, device="cpu",
                               params=params_from_reference(
                                   ref_params, cfg, device="cpu"))
    topo = PodMesh()
    step = pod_lag.make_pod_lag_step(cfg, tcfg, topology=topo)
    masks = []
    for _ in range(STEPS):
        state, m = step(state, batches[1])
        masks.append(m["comm_mask"].tolist())
    want = reference_run(cfgs, batches, "pods:2", "lag-wk", POD_LR)[1]
    assert masks == want and int(state["lag"]["rounds_skipped"]) == 1
    assert state["lag"]["comm_per_worker"].shape == (2,)


def test_async_ring_view_and_push():
    topo = AsyncShards(staleness=1)
    theta = torch.arange(16.0).reshape(2, 8)
    st = topo.extra_state(theta)
    ring = st["theta_ring"]
    assert ring.shape == (2, 2, 8) and torch.equal(ring[1], theta)
    # W = τ+1 with the ramp 0..τ: the ring itself is the view, no copy
    assert topo.worker_views(theta, st, 2) is ring
    view3 = AsyncShards(staleness=2).worker_views(
        theta, AsyncShards(staleness=2).extra_state(theta), 4)
    assert view3.shape == (4, 2, 8)
    new = theta + 100.0
    out = topo.advance_views(st, new)
    assert out["theta_ring"] is ring
    assert torch.equal(ring[0], new) and torch.equal(ring[1], theta)
    with pytest.raises(ValueError, match="needs params"):
        topo.extra_state(None)
    assert BatchShards().worker_views(theta, {}, 2) is None


# ---------------------------------------------------------------------------
# The front doors
# ---------------------------------------------------------------------------

# the deep topologies of the reference's matrix the port runs
# (tests/test_engine.py's DEEP_TOPOLOGY_SPECS without devices:2), each with
# the extras its report carries
DEEP_TOPOLOGY_SPECS = [
    ("shards", {}), ("pods:2", {}), ("async:2@1", {}),
    ("fleet:4@2", {"population": 4, "cohort": 2}),
    ("graph:2@complete", {"num_nodes": 2, "graph_family": "complete"})]


@pytest.mark.parametrize("topology, extra", DEEP_TOPOLOGY_SPECS)
def test_experiment_model_extras(topology, extra):
    r = Experiment(model="llama3.2-1b", algo="lag-wk", topology=topology,
                   steps=3, lr=POD_LR, workers=2, batch=4, seq=16,
                   hetero=0.8, device="cpu", fastpath="on").run()
    N = extra.get("population", 2)
    assert r.comm_mask.shape == (3, N) and r.losses.shape == (3,)
    assert np.isfinite(r.losses).all()
    assert r.topology == topology.split(":")[0]
    assert r.extras["hetero_dial"] == 0.8
    for k, v in extra.items():
        assert r.extras[k] == v
    if topology.startswith("fleet"):
        assert r.extras["cohort_ids"].shape == (3, 2)
        assert r.extras["cohort_comm"].shape == (3, 2)
        assert (r.comms_per_iter <= 2).all()
    else:
        assert "cohort_ids" not in r.extras
    if topology.startswith("graph"):
        # the (K, E) mask is per directed edge (E = 2 on two nodes)
        assert r.extras["edge_src"].tolist() == [0, 1]
        assert r.extras["edge_dst"].tolist() == [1, 0]
    assert ("rounds_skipped" in r.extras) == topology.startswith("pods")
    if topology.startswith("pods"):
        assert r.extras["rounds_skipped"] == int(
            (r.comms_per_iter == 0).sum())
    assert r.bytes_per_upload > 0


def test_experiment_model_priced_on_a_cluster():
    base = dict(model="llama3.2-1b", algo="lag-wk", steps=3, lr=POD_LR,
                batch=4, seq=16, device="cpu")
    r = Experiment(topology="pods:2", cluster="hetero:2@10ms/1Gbps",
                   **base).run()
    assert r.round_seconds.shape == (3,) and r.wall_seconds > 0
    f = Experiment(topology="fleet:6@2", cluster="fleet:6@50ms/20Mbps",
                   **base).run()
    assert f.round_seconds.shape == (3,) and f.extras["cluster"] == "fleet"


# graph:9@ring is ported since the gossip slice (its rejects are in
# tests/test_torch_graph.py), devices since the device plane: outside a
# torch.distributed group of D ranks it raises, naming the launcher (the
# multi-rank runs are tests/test_torch_devrun.py's).  The cases keep the
# ids they had while devices raised "not ported yet".
@pytest.mark.parametrize("kw, exc, match", [
    ({"topology": "sim"}, ValueError, "'shards' or 'pods:N'"),
    ({"topology": "devices:4"}, RuntimeError, "repro_torch.launch.train"),
    ({"topology": "devices:2"}, RuntimeError, "repro_torch.launch.train"),
    ({"model": 3}, ValueError, "ModelConfig or an arch name"),
], ids=["kw0-'shards' or 'pods:N'", "kw1-not ported yet",
        "kw2-not ported yet", "kw3-ModelConfig or an arch name"])
def test_experiment_model_validation(kw, exc, match):
    kw = dict({"model": "llama3.2-1b", "steps": 1, "device": "cpu"}, **kw)
    with pytest.raises(exc, match=match):
        Experiment(**kw).run()


def run_cli(capsys, *flags):
    state = launch_train.main(["--reduced", "--device", "cpu", "--steps",
                               "3", "--workers", "2", "--batch", "4",
                               "--seq", "16", "--lr", str(POD_LR),
                               "--fastpath", "on", *flags])
    return state, capsys.readouterr().out


def test_cli_pods_hetero_cluster(capsys):
    state, out = run_cli(capsys, "--topology", "pods:2", "--hetero", "0.8",
                         "--cluster", "hetero:2@10ms/1Gbps")
    assert "rounds_skipped" in state["lag"]
    assert "simulated wall-clock on 'hetero:2@10ms/1Gbps'" in out
    assert "vs GD" in out and "x advantage" in out
    assert "done: 3 rounds" in out and "of GD" in out


def test_cli_fleet_prices_per_client(capsys):
    state, out = run_cli(capsys, "--topology", "fleet:6@2",
                         "--fleet-selection", "innovation", "--fleet-churn",
                         "0.25", "--cluster", "fleet:6@50ms/20Mbps")
    assert state["lag"]["comm_per_worker"].shape == (6,)
    assert out.count("cohort [") == 3
    assert "vs GD 6 " in out                     # 3 rounds × a cohort of 2
    assert "simulated wall-clock on 'fleet:6@50ms/20Mbps'" in out


def test_cli_async_matches_experiment(capsys):
    state, out = run_cli(capsys, "--topology", "async:2@1")
    assert state["lag"]["theta_ring"].shape[0] == 2
    assert out.count("step ") == 3


@pytest.mark.parametrize("flags, err", [
    (("--cluster", "hetero:9@10ms/1Gbps"), ValueError),
    (("--topology", "fleet:6@2", "--cluster", "hetero:2@10ms/1Gbps"),
     ValueError),
    (("--hetero", "1.5"), ValueError),
    (("--topology", "graph:9@ring"), ValueError),
    (("--topology", "fleet:6@2", "--fleet-churn", "2.0"), ValueError),
])
def test_cli_flag_errors(capsys, flags, err):
    with pytest.raises(err):
        run_cli(capsys, *flags)


def test_experiment_model_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Experiment(model="llama3.2-1b", steps=1).run()
    r = Experiment(model="llama3.2-1b", steps=1, batch=4, seq=8,
                   workers=2, device="cpu").run()
    assert r.comm_mask.shape == (1, 2)
