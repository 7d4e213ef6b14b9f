"""The port's fleet (``repro_torch.fleet``: sampled k-client cohorts over
an N-client population, deep and convex) held against the LIVE JAX
reference (``repro.fleet``).

The reference draws its cohorts and churn with ``jax.random``, which
PyTorch cannot reproduce: the port takes the draws as operands, and these
tests inject the reference's own (the deep step's ``fold_in(fold_in(
PRNGKey(seed), step), 1)`` split, the convex run's ``0x0F1EE7`` chain).
On them the cohorts and upload masks are the reference's, losses within
rtol 1e-4.  ``fleet:M@M`` is bitwise the port's ``shards`` and the convex
``fleet:N@N`` bitwise its ``sim``.  The compact view, the sampler's ties,
the churn chain and the problem generator are bitwise.  No golden file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.configs import get_config as jget_config
from repro.data import TokenStream as JTokenStream
from repro.data import make_heterogeneous_inputs as jmake_hetero
from repro.dist import TrainerConfig as JTrainerConfig
from repro.engine import Experiment as JExperiment
from repro.fastpath.layout import FlatLayout as JFlatLayout
from repro.fleet import sampling as jsampling
from repro.fleet import selection as jselection

from repro_torch import fleet
from repro_torch.configs import get_config
from repro_torch.core.convex import Problem
from repro_torch.data import TokenStream, make_heterogeneous_inputs
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step, param_layout)
from repro_torch.engine import Experiment, make_topology
from repro_torch.fastpath.layout import FlatLayout
from repro_torch.fleet import sampling, selection
from repro_torch.fleet.population import INNOV_INIT, MIRROR_PREFIX, Population
from repro_torch.fleet.topology import FleetTopology
from repro_torch.weights import params_from_reference

BATCH, SEQ, STEPS = 4, 32, 3
LOSS_RTOL = 1e-4


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


def to_np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The compact per-client view
# ---------------------------------------------------------------------------

TREES = {
    "ragged": {"w": (3, 5), "b": (7,), "e": (0,), "z": (2, 128)},
    "one-leaf": {"t": (4,)},
    "lanes": {"a": (128,), "b": (129,), "c": (1,)},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_pack_unpack_round_trip_bitwise(name):
    shapes = TREES[name]
    rng = np.random.default_rng(3)
    W = 5
    stacked = {k: rng.standard_normal((W,) + s).astype(np.float32)
               for k, s in shapes.items()}
    tmpl = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    jlo = JFlatLayout.for_tree(jax.tree_util.tree_map(jnp.asarray, tmpl))
    lo = FlatLayout.for_tree({k: torch.from_numpy(v)
                              for k, v in tmpl.items()})
    assert lo.packed_cols == jlo.packed_cols
    assert lo.leaf_lanes == jlo.leaf_lanes
    got = lo.pack_stacked({k: torch.from_numpy(v)
                           for k, v in stacked.items()})
    want = jlo.pack_stacked(jax.tree_util.tree_map(jnp.asarray, stacked))
    assert bits_equal(to_np(got), np.asarray(want))
    back = lo.unpack_stacked(got)
    jback = jlo.unpack_stacked(want)
    for k in shapes:
        assert bits_equal(to_np(back[k]), np.asarray(jback[k]))
        assert bits_equal(to_np(back[k]), stacked[k])


def test_population_gather_scatter_with_dropout_revert():
    tmpl = {"w": torch.zeros(3, 5), "b": torch.zeros(7),
            "e": torch.zeros(0)}
    lo = FlatLayout.for_tree(tmpl)
    pop = Population.for_template(tmpl, ("grad_hat",), size=9)
    st = pop.init_state("cpu")
    assert st[MIRROR_PREFIX + "grad_hat"].shape == (9, lo.packed_cols)
    cohort = torch.tensor([1, 4, 8])
    gen = torch.Generator().manual_seed(0)
    buf = lo.empty((3,))
    lo.unflatten_stacked(buf)["w"].normal_(generator=gen)
    lo.unflatten_stacked(buf)["b"].normal_(generator=gen)
    pop.scatter_state(st, cohort, {"grad_hat": buf})
    back = pop.gather_state(st, cohort)["grad_hat"]
    assert back.shape == (3, lo.rows, 128) and torch.equal(back, buf)
    # the other clients' rows stay zero; the compact rows are the packed
    # view of the plane rows
    rows = st[MIRROR_PREFIX + "grad_hat"]
    assert not rows[[0, 2, 3, 5, 6, 7]].any()
    assert torch.equal(rows[cohort], lo.pack_stacked(
        lo.unflatten_stacked(buf)))
    # mid-round dropouts revert EXACTLY
    bumped = buf + 1.0
    active = torch.tensor([True, False, True])
    pop.scatter_state(st, cohort, {"grad_hat": bumped}, active)
    after = pop.gather_state(st, cohort)["grad_hat"]
    assert torch.equal(after[1], buf[1])
    assert torch.equal(lo.unflatten_stacked(after)["b"][0],
                       lo.unflatten_stacked(bumped)["b"][0])


def test_population_mirrors_follow_the_policy_dtypes():
    from repro_torch.comm import make_policy
    lo = FlatLayout.for_tree(torch.zeros(4, dtype=torch.float64))
    pop = Population.for_policy(lo, make_policy("laq@4", fastpath=None), 6)
    st = pop.init_state("cpu")
    assert st[MIRROR_PREFIX + "grad_hat"].dtype == torch.float64
    assert st[MIRROR_PREFIX + "resid"].dtype == torch.float32
    assert st["fleet_alive"].all() and not st["fleet_age"].any()
    assert (st["fleet_innov"] == INNOV_INIT).all()


# ---------------------------------------------------------------------------
# Sampling on injected draws: the reference's ids and masks
# ---------------------------------------------------------------------------

def jdraws(key, N):
    ksel, kchurn = jax.random.split(key)
    return (np.array(jax.random.gumbel(ksel, (N,), jnp.float32)),
            np.array(jax.random.uniform(kchurn, (N,), jnp.float32)))


SAMPLE_CASES = [
    # (N, k, alive pattern, seed)
    (12, 12, "all", 0), (12, 5, "all", 1), (64, 7, "half", 2),
    (10, 6, "thin", 3),        # 3 alive < k = 6: dead ties by index
    (10, 4, "none", 4),        # nobody alive: the lowest ids
    (1000, 33, "random", 5)]


def alive_of(pattern, N, seed):
    if pattern == "all":
        return np.ones(N, bool)
    if pattern == "half":
        return np.arange(N) % 2 == 0
    if pattern == "thin":
        return np.isin(np.arange(N), [2, 5, 9])
    if pattern == "none":
        return np.zeros(N, bool)
    return np.random.default_rng(seed).uniform(size=N) < 0.7


@pytest.mark.parametrize("N, k, pattern, seed", SAMPLE_CASES)
@pytest.mark.parametrize("rule", ["uniform", "innovation"])
def test_gumbel_top_k_on_injected_draws(N, k, pattern, seed, rule):
    g, _ = jdraws(jax.random.PRNGKey(seed), N)
    alive = alive_of(pattern, N, seed)
    rng = np.random.default_rng(seed + 100)
    innov = np.where(rng.uniform(size=N) < 0.3, INNOV_INIT,
                     rng.uniform(1e-4, 10.0, size=N)).astype(np.float32)
    age = rng.integers(0, 9, size=N).astype(np.int32)
    jst = {"fleet_innov": jnp.asarray(innov), "fleet_age": jnp.asarray(age)}
    st = {"fleet_innov": torch.from_numpy(innov),
          "fleet_age": torch.from_numpy(age)}
    jscores = jselection.make_selection(rule)(jst)
    scores = selection.make_selection(rule)(st)
    assert bits_equal(to_np(scores), np.asarray(jscores))
    want = np.asarray(jsampling.gumbel_top_k(
        jax.random.split(jax.random.PRNGKey(seed))[0], jscores,
        jnp.asarray(alive), k))
    got = sampling.gumbel_top_k(torch.from_numpy(g), scores,
                                torch.from_numpy(alive), k)
    assert got.tolist() == want.tolist()
    if pattern == "thin":
        assert got.tolist() == [0, 1, 2, 3, 5, 9]
    if k == N:
        assert got.tolist() == list(range(N))


@pytest.mark.parametrize("churn", [0.0, 0.25, 1.0])
def test_churn_step_on_injected_draws(churn):
    N = 200
    _, u = jdraws(jax.random.PRNGKey(7), N)
    alive = np.random.default_rng(1).uniform(size=N) < 0.6
    jalive = jnp.asarray(alive)
    talive = torch.from_numpy(alive)
    got = sampling.churn_step(torch.from_numpy(u), talive, churn)
    want = jsampling.churn_step(jax.random.split(jax.random.PRNGKey(7))[1],
                                jalive, churn)
    assert got.tolist() == np.asarray(want).tolist()
    if churn == 0.0:
        # structural identity: the same tensor, no draw read
        assert got is talive
        assert sampling.churn_step(None, talive, 0.0) is talive


def test_sampling_validation_matches_reference():
    scores, alive = torch.ones(5), torch.ones(5, dtype=torch.bool)
    for k in (0, 6):
        with pytest.raises(ValueError, match="cohort size"):
            sampling.gumbel_top_k(torch.zeros(5), scores, alive, k)
    for c in (-0.1, 1.5):
        with pytest.raises(ValueError) as got:
            sampling.churn_step(torch.zeros(5), alive, c)
        with pytest.raises(ValueError) as want:
            jsampling.churn_step(jax.random.PRNGKey(0), jnp.ones(5, bool), c)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        selection.make_selection("roulette")
    with pytest.raises(ValueError) as want:
        jselection.make_selection("roulette")
    assert str(got.value) == str(want.value)
    assert sampling.REJOIN == jsampling.REJOIN
    assert selection.AGE_BOOST == jselection.AGE_BOOST


def test_innovation_scores_ordering():
    N = 10
    st = {"fleet_age": torch.zeros(N, dtype=torch.int32),
          "fleet_innov": torch.tensor([1e-3] * 7 + [INNOV_INIT] * 3)}
    scores = selection.innovation_scores(st)
    alive = torch.ones(N, dtype=torch.bool)
    for s in range(8):
        g, _ = sampling.host_draws(s, 0, N, 0.0)
        assert set(sampling.gumbel_top_k(g, scores, alive, 3).tolist()) \
            == {7, 8, 9}
    aged = dict(st, fleet_age=torch.tensor([100] + [0] * (N - 1),
                                           dtype=torch.int32))
    s_aged = selection.innovation_scores(aged)
    assert float(s_aged[0]) > float(s_aged[1])
    assert torch.unique(selection.uniform_scores(st)).numel() == 1


def test_host_draws_deterministic():
    g1, u1 = sampling.host_draws(3, 7, 50, 0.25)
    g2, u2 = sampling.host_draws(3, 7, 50, 0.25)
    assert torch.equal(g1, g2) and torch.equal(u1, u2)
    g3, u3 = sampling.host_draws(3, 8, 50, 0.0)
    assert u3 is None and not torch.equal(g1, g3)
    assert torch.isfinite(g1).all() and ((u1 >= 0) & (u1 < 1)).all()


# ---------------------------------------------------------------------------
# The problem generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind, kw", [("linreg", {}),
                                      ("logreg", {"lam": 0.1}),
                                      ("linreg", {"n_per": 3, "d": 7})])
def test_fleet_problem_bitwise(kind, kw):
    want = jfleet.fleet_problem(kind, num_clients=300, seed=4, **kw)
    got = fleet.fleet_problem(kind, num_clients=300, seed=4, device="cpu",
                              **kw)
    for f in ("X", "y", "L_m"):
        assert bits_equal(to_np(getattr(got, f)), np.asarray(getattr(want,
                                                                    f)))
    assert got.L == want.L and got.lam == want.lam
    assert got.name == want.name and got.kind == want.kind


def test_fleet_problem_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        fleet.fleet_problem(num_clients=4)


def test_fleet_topology_validation_matches_reference():
    for kw in ({"population": 10, "cohort": 2, "churn": 1.5},
               {"population": 10, "cohort": 2, "selection": "roulette"},
               {"population": 10, "cohort": 11},
               {"population": 0, "cohort": 1}):
        with pytest.raises(ValueError) as got:
            FleetTopology(**kw)
        with pytest.raises(ValueError) as want:
            jfleet.FleetTopology(**kw)
        assert str(got.value) == str(want.value)
    t = make_topology("fleet:100000@64")
    assert t.units(8) == 64 and t.name == "fleet" and t.kind == "deep"


def test_fleet_package_surface():
    assert set(jfleet.__all__) <= set(fleet.__all__)


# ---------------------------------------------------------------------------
# The deep fleet against the reference (the reference's draws injected)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cfgs():
    return jget_config("llama3.2-1b").reduced(), \
        get_config("llama3.2-1b").reduced()


def deep_draw(seed, N):
    """The reference deep step's cohort draws at step k."""
    def draw(step):
        root = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        return jdraws(jax.random.fold_in(root, 1), N)
    return draw


DEEP_CASES = [("lag-wk", 0.0, "uniform"), ("lag-ps", 0.0, "uniform"),
              ("laq@4", 0.0, "uniform"), ("lag-wk", 0.25, "innovation")]


@pytest.mark.parametrize("algo, churn, rule", DEEP_CASES)
def test_deep_fleet_matches_reference(cfgs, algo, churn, rule):
    jcfg, cfg = cfgs
    N, k, lr = 4, 2, 0.3
    jtopo = jfleet.FleetTopology(population=N, cohort=k, churn=churn,
                                 selection=rule)
    jt = JTrainerConfig(algo=algo, num_workers=k, lr=lr)
    jst = jfleet.init_fleet_state(jax.random.PRNGKey(0), jcfg, jt, jtopo)
    jstep = jax.jit(jfleet.make_fleet_step(jcfg, jt, jtopo))
    jb = jmake_hetero(jcfg, JTokenStream(jcfg.vocab_size), 0, k, BATCH, SEQ)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jst["params"]), cfg,
        device="cpu")
    topo = FleetTopology(N, k, churn=churn, selection=rule,
                         draw=deep_draw(0, N))
    tcfg = TrainerConfig(algo=algo, num_workers=k, lr=lr, fastpath="on")
    st = fleet.init_fleet_state(cfg, tcfg, topo, device="cpu", params=params)
    step = fleet.make_fleet_step(cfg, tcfg, topo)
    b = make_heterogeneous_inputs(cfg, TokenStream(cfg.vocab_size), 0, k,
                                  BATCH, SEQ, device="cpu")
    for r in range(STEPS):
        jst, jm = jstep(jst, jb)
        st, m = step(st, b)
        assert m["cohort_ids"].tolist() == np.asarray(
            jm["cohort_ids"]).tolist(), r
        assert m["cohort_comm"].tolist() == np.asarray(
            jm["cohort_comm"]).tolist(), r
        assert m["comm_mask"].tolist() == np.asarray(
            jm["comm_mask"]).tolist(), r
        assert m["cohort_active"].tolist() == np.asarray(
            jm["cohort_active"]).tolist(), r
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    for key in ("fleet_alive", "fleet_age", "comm_per_worker", "comm_total"):
        assert to_np(st["lag"][key]).tolist() == np.asarray(
            jst["lag"][key]).tolist(), key
    np.testing.assert_allclose(to_np(st["lag"]["fleet_innov"]),
                               np.asarray(jst["lag"]["fleet_innov"]),
                               rtol=1e-3)


@pytest.mark.parametrize("algo, fastpath", [
    ("lag-wk", "on"), ("lag-ps", "on"), ("laq@4", "on"), ("lasg-wk", "on"),
    ("lag-wk", "auto"), ("laq@4", "auto")])
def test_full_cohort_fleet_is_bitwise_shards(cfgs, algo, fastpath):
    _, cfg = cfgs
    M = 2
    tcfg = TrainerConfig(algo=algo, num_workers=M, lr=0.3,
                         fastpath=fastpath)
    topo = make_topology(f"fleet:{M}@{M}")
    fst = fleet.init_fleet_state(cfg, tcfg, topo, device="cpu", seed=3)
    sst = init_state(cfg, tcfg, device="cpu", params=None, seed=3)
    assert torch.equal(fst["theta"], sst["theta"])
    fstep = fleet.make_fleet_step(cfg, tcfg, topo)
    sstep = make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size)
    for r in range(STEPS):
        b = make_heterogeneous_inputs(cfg, stream, r, M, BATCH, SEQ,
                                      fixed=False, device="cpu")
        fst, fm = fstep(fst, b)
        sst, sm = sstep(sst, b)
        assert fm["cohort_ids"].tolist() == list(range(M))
        assert torch.equal(fm["comm_mask"], sm["comm_mask"])
        assert bits_equal(to_np(fm["loss"]), to_np(sm["loss"]))
    assert torch.equal(fst["theta"], sst["theta"])
    assert torch.equal(fst["lag"]["nabla"], sst["lag"]["nabla"])
    plo = param_layout(cfg)
    for key in tcfg.comm_policy().state_keys:
        assert torch.equal(fst["lag"][MIRROR_PREFIX + key],
                           plo.pack_stacked(plo.unflatten_stacked(
                               sst["lag"][key])))


# ---------------------------------------------------------------------------
# The convex fleet
# ---------------------------------------------------------------------------

def convex_draw(seed, N):
    """The reference convex run's cohort draws: the 0x0F1EE7 chain."""
    keys = [jax.random.fold_in(jax.random.PRNGKey(seed), 0x0F1EE7)]
    cache = {}

    def draw(step):
        while len(cache) <= step:
            skey, sround = jax.random.split(keys[-1])
            keys.append(skey)
            cache[len(cache)] = jdraws(sround, N)
        return cache[step]
    return draw


def on_cpu_problem(jprob):
    """The reference's problem as the port's, bitwise."""
    put = lambda a: torch.from_numpy(np.array(a))
    return Problem(name=jprob.name, kind=jprob.kind, X=put(jprob.X),
                   y=put(jprob.y), L_m=put(jprob.L_m), L=jprob.L,
                   lam=jprob.lam)


@pytest.mark.parametrize("algo, churn, rule, fastpath", [
    ("lag-wk", 0.0, "uniform", None), ("lag-wk", 0.0, "uniform", "on"),
    ("lag-ps", 0.0, "uniform", "on"), ("laq@4", 0.0, "uniform", "on"),
    ("lag-wk", 0.2, "innovation", None)])
def test_convex_fleet_matches_reference(algo, churn, rule, fastpath):
    N, k, K = 200, 8, 60
    jprob = jfleet.fleet_problem("linreg", num_clients=N, n_per=2, d=4,
                                 seed=1)
    prob = on_cpu_problem(jprob)
    _, opt = prob.optimum()
    cluster = f"fleet:{N}@50ms/20Mbps"
    want = JExperiment(problem=jprob, algo=algo, steps=K, opt_loss=opt,
                       topology=jfleet.FleetTopology(N, k, churn=churn,
                                                     selection=rule),
                       cluster=cluster).run()
    got = Experiment(problem=prob, algo=algo, steps=K, opt_loss=opt,
                     fastpath=fastpath, cluster=cluster,
                     topology=FleetTopology(N, k, churn=churn,
                                            selection=rule,
                                            draw=convex_draw(0, N))).run()
    assert np.array_equal(got.extras["cohort_ids"],
                          np.asarray(want.extras["cohort_ids"]))
    n = want.iters_to(1e-4)
    n = K if n is None else n + 1
    assert n > 5
    assert np.array_equal(got.comm_mask[:n], np.asarray(want.comm_mask[:n]))
    assert np.array_equal(got.extras["cohort_comm"][:n],
                          np.asarray(want.extras["cohort_comm"][:n]))
    np.testing.assert_allclose(got.losses[:n], want.losses[:n], rtol=1e-5)
    assert got.comm_mask.shape == (K, N)
    assert got.extras["population"] == N and got.extras["cohort"] == k
    for key in ("churn", "selection", "L_m_spread", "hetero_score"):
        assert got.extras[key] == want.extras[key], key
    if n == K:
        assert got.wall_seconds == want.wall_seconds
    else:
        np.testing.assert_allclose(got.round_seconds[:n],
                                   want.round_seconds[:n], rtol=0)
    assert got.bytes_per_upload == want.bytes_per_upload


@pytest.mark.parametrize("algo, dt", [
    ("lag-wk", torch.float32), ("lag-ps", torch.float32),
    ("laq@4", torch.float32), ("lasg-wk", torch.float32),
    ("lag-wk", torch.float64), ("num-iag", torch.float64)])
def test_convex_full_cohort_fleet_is_bitwise_sim(algo, dt):
    prob = fleet.fleet_problem("linreg", num_clients=6, n_per=8, d=5,
                               seed=2, dtype=dt, device="cpu")
    kw = dict(problem=prob, algo=algo, steps=40, opt_loss=0.0)
    if dt == torch.float32:
        kw["fastpath"] = "on"
    sim = Experiment(**kw).run()
    flt = Experiment(topology="fleet:6@6", **kw).run()
    assert np.array_equal(sim.comm_mask, flt.comm_mask)
    assert bits_equal(sim.losses, flt.losses)
    assert np.array_equal(flt.extras["cohort_ids"],
                          np.tile(np.arange(6), (40, 1)))


def test_convex_fleet_population_mismatch_is_actionable():
    prob = fleet.fleet_problem("linreg", num_clients=6, n_per=4, d=3,
                               device="cpu")
    with pytest.raises(ValueError, match="fleet_problem"):
        Experiment(problem=prob, algo="lag-wk", steps=2, opt_loss=0.0,
                   topology="fleet:9@3").run()


def test_convex_fleet_own_draws_priced():
    N, k, K = 200, 8, 25
    prob = fleet.fleet_problem("linreg", num_clients=N, n_per=2, d=4,
                               seed=1, device="cpu")
    runs = [Experiment(problem=prob, algo="lag-wk", steps=K, opt_loss=0.0,
                       topology=f"fleet:{N}@{k}", fastpath=fp,
                       cluster=f"fleet:{N}@50ms/20Mbps").run()
            for fp in (None, "on")]
    r = runs[0]
    assert r.comm_mask.shape == (K, N)
    assert (r.comms_per_iter <= k).all() and np.isfinite(r.losses).all()
    assert r.wall_seconds > 0 and r.extras["cluster"] == "fleet"
    # the host draws are the same on both routes: the same cohorts
    assert np.array_equal(runs[0].extras["cohort_ids"],
                          runs[1].extras["cohort_ids"])
