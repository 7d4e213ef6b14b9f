"""The port's netsim (``repro_torch.netsim``: the cluster cost model and the
convex heterogeneity dial) and ``RunReport`` held against the live JAX
reference (``repro.netsim``, ``repro.engine.report``).

The cost model is numpy on the host in both packages: every price is
bitwise the reference's on the same mask.  The dial's data come from the
same numpy streams: bitwise too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import Experiment as JExperiment
from repro.engine.report import RunReport as JRunReport
from repro.netsim import cluster as jcluster
from repro.netsim import hetero as jhetero

from repro_torch.engine import Experiment, RunReport
from repro_torch.netsim import cluster, hetero

SPECS = ("uniform:9@10ms/1Gbps", "hetero:9@10ms/1Gbps",
         "straggler:4@1ms/10Gbps", "fleet:50@5ms/100Mbps",
         "hetero:3@50us/125MBps", "uniform:2@1s/56Kbps")


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def same_cluster(a, b):
    return (a.name == b.name
            and (a.bcast.latency_s, a.bcast.bandwidth_Bps)
            == (b.bcast.latency_s, b.bcast.bandwidth_Bps)
            and a.server_bw_Bps == b.server_bw_Bps
            and a.straggler_sigma == b.straggler_sigma and a.seed == b.seed
            and all(bits_equal(getattr(a, f), getattr(b, f))
                    for f in ("up_latency_s", "up_bw_Bps", "compute_s")))


@pytest.mark.parametrize("spec", SPECS)
def test_make_cluster_matches_reference(spec):
    got, want = cluster.make_cluster(spec), jcluster.make_cluster(spec)
    assert same_cluster(got, want)
    assert bits_equal(got.compute_jitter(7), want.compute_jitter(7))
    # a Cluster passes through; the worker count defaults from the run
    assert cluster.make_cluster(got) is got
    assert same_cluster(cluster.make_cluster("hetero@1ms/1Gbps", 5),
                        jcluster.make_cluster("hetero@1ms/1Gbps", 5))


@pytest.mark.parametrize("spec, workers", [
    ("bogus:4@1ms/1Gbps", None), ("hetero:x@1ms/1Gbps", None),
    ("hetero:0", None), ("hetero:9@10ms/1Gbps", 4), ("hetero", None),
    ("hetero:4@10ms", None), ("hetero:4@10xs/1Gbps", None),
    ("hetero:4@10ms/1Gbit", None), ("", None), (3, None)])
def test_make_cluster_errors_match_reference(spec, workers):
    with pytest.raises(ValueError) as got:
        cluster.make_cluster(spec, workers)
    with pytest.raises(ValueError) as want:
        jcluster.make_cluster(spec, workers)
    assert str(got.value) == str(want.value)


def masks(K, M, seed, p=0.4):
    return np.random.default_rng(seed).uniform(size=(K, M)) < p


@pytest.mark.parametrize("spec", SPECS)
def test_price_mask_bitwise(spec):
    cl = cluster.make_cluster(spec)
    jcl = jcluster.make_cluster(spec)
    m = masks(60, cl.num_workers, 1)
    for dense in (None, 1234.0):
        got = cluster.price_mask(m, 400.0, cl, dense_bytes=dense)
        assert bits_equal(got, jcluster.price_mask(m, 400.0, jcl,
                                                   dense_bytes=dense))
    with pytest.raises(ValueError, match="workers"):
        cluster.price_mask(masks(3, cl.num_workers + 1, 0), 1.0, cl)


@pytest.mark.parametrize("spec", ["uniform:12@1ms/1Gbps",
                                  "straggler:12@2ms/100Mbps"])
def test_price_edge_mask_bitwise(spec):
    cl, jcl = cluster.make_cluster(spec), jcluster.make_cluster(spec)
    m = masks(40, 12, 2)
    dst = np.random.default_rng(3).integers(0, 5, 12)
    got = cluster.price_edge_mask(m, 64.0, cl, dst, dense_bytes=512.0)
    assert bits_equal(got, jcluster.price_edge_mask(m, 64.0, jcl, dst,
                                                    dense_bytes=512.0))


@pytest.mark.parametrize("spec", ["fleet:200@5ms/50Mbps",
                                  "straggler:200@1ms/1Gbps"])
def test_price_cohort_mask_bitwise(spec):
    cl, jcl = cluster.make_cluster(spec), jcluster.make_cluster(spec)
    rng = np.random.default_rng(4)
    ids = np.stack([rng.choice(200, 16, replace=False) for _ in range(30)])
    m = masks(30, 16, 5)
    got = cluster.price_cohort_mask(ids, m, 29.0, cl, dense_bytes=400.0)
    assert bits_equal(got, jcluster.price_cohort_mask(ids, m, 29.0, jcl,
                                                      dense_bytes=400.0))


def reports(K=50, W=9, seed=6):
    rng = np.random.default_rng(seed)
    losses = 1.0 + np.exp(-np.arange(K) / 7.0) + 1e-9 * rng.uniform(size=K)
    mask = masks(K, W, seed)
    kw = dict(algo="lag-wk", losses=losses, comm_mask=mask, opt_loss=1.0,
              bytes_per_upload=400.0)
    return RunReport(**kw), JRunReport(**kw)


def test_run_report_accessors_match_reference():
    got, want = reports()
    for eps in (1e-1, 1e-3, 1e-30):
        assert got.iters_to(eps) == want.iters_to(eps)
        assert got.comms_to(eps) == want.comms_to(eps)
        assert got.bytes_to(eps) == want.bytes_to(eps)
        assert got.summary(eps) == want.summary(eps)
    assert bits_equal(got.cum_wire_bytes, want.cum_wire_bytes)
    assert (got.num_units, got.total_comms, got.wire_bytes) == \
        (want.num_units, want.total_comms, want.wire_bytes)
    with pytest.raises(ValueError, match="no simulated wall-clock"):
        got.wall_seconds


def test_price_reports_match_reference():
    got, want = reports()
    cluster.price_report(got, "hetero:9@10ms/1Gbps", dense_bytes=800.0)
    jcluster.price_report(want, "hetero:9@10ms/1Gbps", dense_bytes=800.0)
    assert bits_equal(got.round_seconds, want.round_seconds)
    assert bits_equal(got.cum_seconds, want.cum_seconds)
    assert got.extras == want.extras
    assert got.seconds_to(1e-3) == want.seconds_to(1e-3)
    assert got.summary(1e-3) == want.summary(1e-3)
    # the graph and fleet pricers read their maps from the extras
    got, want = reports(W=12)
    dst = np.arange(12) % 4
    got.extras["edge_dst"] = want.extras["edge_dst"] = dst
    cluster.price_edge_report(got, "uniform@1ms/1Gbps")
    jcluster.price_edge_report(want, "uniform@1ms/1Gbps")
    assert bits_equal(got.round_seconds, want.round_seconds)
    got, want = reports(W=40)
    rng = np.random.default_rng(8)
    ids = np.stack([rng.choice(40, 8, replace=False) for _ in range(50)])
    for r in (got, want):
        r.extras.update(cohort_ids=ids, cohort_comm=masks(50, 8, 9))
    cluster.price_fleet_report(got, "fleet@5ms/50Mbps")
    jcluster.price_fleet_report(want, "fleet@5ms/50Mbps")
    assert bits_equal(got.round_seconds, want.round_seconds)
    with pytest.raises(ValueError, match="edge_dst"):
        cluster.price_edge_report(reports()[0], "uniform@1ms/1Gbps")


@pytest.mark.parametrize("M", [1, 4, 9])
@pytest.mark.parametrize("h", [0.0, 0.3, 0.8, 1.0])
def test_hetero_L_targets_bitwise(M, h):
    assert bits_equal(hetero.hetero_L_targets(M, h),
                      jhetero.hetero_L_targets(M, h))


def test_hetero_L_targets_errors():
    for args in ((9, 1.5), (9, -0.1), (0, 0.5)):
        with pytest.raises(ValueError):
            hetero.hetero_L_targets(*args)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind, h", [("linreg", 0.8), ("logreg", 0.3)])
def test_hetero_problem_and_measurables(kind, h, dt):
    f64 = dt == torch.float64
    with jax.enable_x64(f64):
        jp = jhetero.hetero_problem(kind, h=h, lam=1e-2 * (kind == "logreg"),
                                    dtype=jnp.float64 if f64 else None)
        want = [np.asarray(jp.X), np.asarray(jp.y), np.asarray(jp.L_m)]
        spread = jhetero.realized_spread(jp.L_m)
        score = jhetero.hetero_score(jp.L_m, alpha=1 / jp.L, xi=0.1, D=10)
    p = hetero.hetero_problem(kind, h=h, lam=1e-2 * (kind == "logreg"),
                              dtype=dt if f64 else None, device="cpu")
    assert (p.name, p.L) == (jp.name, jp.L)
    for got, w in zip((p.X, p.y, p.L_m), want):
        assert bits_equal(got.numpy(), w)
    assert hetero.realized_spread(p.L_m) == spread
    assert hetero.hetero_score(p.L_m, alpha=1 / p.L, xi=0.1, D=10) == score
    # numpy and list inputs measure the same
    assert hetero.realized_spread(list(want[2])) == spread


@pytest.mark.parametrize("algo", ["lag-wk", "lag-ps"])
def test_experiment_cluster_end_to_end(algo):
    """The dial's float64 problem priced on the hetero cluster: the upload
    masks and the priced seconds equal the reference's through
    ``iters_to(1e-6)`` (past the optimum the triggers compare round-off),
    and so does ``seconds_to(1e-8)``."""
    K, spec = 120, "hetero:9@10ms/1Gbps"
    with jax.enable_x64(True):
        jp = jhetero.hetero_problem("linreg", h=0.8, dtype=jnp.float64)
        _, opt = jp.optimum()
        want = JExperiment(problem=jp, algo=algo, steps=K, cluster=spec,
                           opt_loss=opt).run()
    p = hetero.hetero_problem("linreg", h=0.8, dtype=torch.float64,
                              device="cpu")
    got = Experiment(problem=p, algo=algo, steps=K, cluster=spec,
                     opt_loss=opt).run()
    k = want.iters_to(1e-6)
    assert np.array_equal(got.comm_mask[:k + 1], want.comm_mask[:k + 1])
    assert bits_equal(got.round_seconds[:k + 1], want.round_seconds[:k + 1])
    assert got.seconds_to(1e-8) == want.seconds_to(1e-8) is not None
    assert got.extras["cluster"] == "hetero"
    assert got.extras["wall_seconds"] == got.wall_seconds
    assert got.extras["L_m_spread"] == want.extras["L_m_spread"]


def test_priced_tail_past_the_optimum_is_round_off():
    """Phase 12d of ``chip_smoke.py`` holds the card's ``wall_seconds`` to
    the CPU run's within rtol 1e-3, not exactly.  The witness that the
    priced tail is round-off: two runs of the same float64 problem on the
    same CPU, the port's and the reference's, upload the same workers
    through the optimum and first differ only in a round whose loss is
    within a few float64 ulps of it; their ``wall_seconds`` then differ by
    far less than 1e-3.  Run with ``-s`` to print the readings."""
    K, spec = 600, "hetero:9@10ms/1Gbps"
    with jax.enable_x64(True):
        jp = jhetero.hetero_problem("linreg", h=0.8, dtype=jnp.float64)
        _, opt = jp.optimum()
        want = JExperiment(problem=jp, algo="lag-wk", steps=K, cluster=spec,
                           opt_loss=opt).run()
    p = hetero.hetero_problem("linreg", h=0.8, dtype=torch.float64,
                              device="cpu")
    got = Experiment(problem=p, algo="lag-wk", steps=K, cluster=spec,
                     opt_loss=opt).run()
    differ = (got.comm_mask != want.comm_mask).any(axis=1).nonzero()[0]
    first = int(differ[0]) if differ.size else K
    k = want.iters_to(1e-6)
    gap = abs(want.losses[first - 1] - opt) if differ.size else 0.0
    rtol = abs(got.wall_seconds / want.wall_seconds - 1.0)
    print(f"lag-wk on {spec}, K {K}: iters_to(1e-6) {k}; first upload "
          f"difference at round {first} of {K} ({differ.size} rounds "
          f"differ), gap to the optimum before it {gap:.3e}; wall_seconds "
          f"port {got.wall_seconds!r}, reference {want.wall_seconds!r}, "
          f"rtol {rtol:.3e}")
    assert first > k
    assert gap <= 8 * np.finfo(np.float64).eps * abs(opt)
    assert got.seconds_to(1e-8) == want.seconds_to(1e-8) is not None
    assert rtol <= 1e-3
