"""The port's convex simulation (``repro_torch.core.convex``,
``core.simulate``, ``engine.topology.SimWorkers``, ``engine.experiment``)
held against the live JAX reference, plus the float64 repairs it needed.

The same numpy data go through both packages (the generators are bitwise
the reference's).  Tolerances: bitwise for data, layouts and the numpy
closed forms; rtol 1e-12 for float64 losses and gradients (the two
packages' matrix products add in different orders); rtol 1e-5 for float32
losses.  Upload masks are equal through ``iters_to(1e-6)`` of the
reference run: past the optimum the triggers compare round-off.

Two reference behaviours are injected rather than reproduced, each a known
difference of the reference's XLA-CPU arithmetic (ROADMAP queue 3):
num-IAG's ``jax.random`` draw (through ``SampledSchedule(draw=…)``), and in
LAQ's encode XLA-CPU's quantizer step ``scale × f32(1/qmax)`` (a multiply
by the reciprocal where the port divides) and its fused residual
``v − codes·step`` (one rounding where the port rounds the product first).
The port's own LAQ arithmetic is held to the reference separately: the
same uploads through round 20 at least, losses within 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convex as jconvex
from repro.core import lag as jlag
from repro.core import simulate as jsim

from repro_torch import comm
from repro_torch.comm import SampledSchedule, ScheduledPolicy
from repro_torch.core import convex, lag, simulate
from repro_torch.engine import Experiment, rounds
from repro_torch.fastpath.layout import FlatLayout
from repro_torch.kernels.lag_trigger import ref as lag_ref
from repro_torch.netsim import hetero_problem

F64_RTOL = 1e-12
F32_RTOL = 1e-5
K64 = 600
K32 = 40
LAQ32_EPS = 1e-1
LAQ32_RTOL = 1e-3
LAQ_OWN_FIRST = 20

# the Motivation table: convex.synthetic("linreg", num_workers=9, seed=0,
# float64), ε = 1e-8 — (iters_to, comms_to, bytes_to, bytes per upload)
TABLE = {
    "gd": (62, 567, 226_800.0, 400.0),
    "lag-wk": (66, 122, 48_800.0, 400.0),
    "lag-ps": (78, 153, 61_200.0, 400.0),
    "lasg-wk": (66, 122, 48_800.0, 400.0),
    "laq": (65, 162, 4_698.0, 29.0),
    "cyc-iag": (555, 556, 222_400.0, 400.0),
    "num-iag": (528, 529, 211_600.0, 400.0),
}
HETERO = {"gd": 0.0, "lag-wk": 0.0, "lag-ps": 1 / 9, "laq": 0.0,
          "lasg-wk": 0.0, "cyc-iag": 4 / 9, "num-iag": 4 / 9}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its rounds are hundreds of
    small ops, which several test processes' thread pools on the same cores
    slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def jdtype(dt):
    return jnp.float64 if dt == torch.float64 else jnp.float32


# ---------------------------------------------------------------------------
# The reference, run once per configuration
# ---------------------------------------------------------------------------

_REF = {}


def reference(spec, dt, K, gen="fig3", **kw):
    """(problem, opt_loss, report) of the live reference; float64 under a
    scoped x64."""
    key = (spec, str(dt), K, gen, tuple(sorted(kw.items())))
    if key not in _REF:
        with jax.enable_x64(dt == torch.float64):
            if gen == "fig3":
                jp = jconvex.synthetic("linreg", num_workers=9, seed=0,
                                       dtype=jdtype(dt))
            else:
                from repro.netsim import hetero_problem as jhetero
                jp = jhetero("linreg", h=0.8, dtype=jdtype(dt))
            _, opt = jp.optimum()
            _REF[key] = (jp, opt, jsim.run(jp, spec, K=K, opt_loss=opt,
                                           **kw))
    return _REF[key]


def fig3(dt):
    return convex.synthetic("linreg", num_workers=9, seed=0, dtype=dt,
                            device="cpu")


def injected(spec, ref_report, fastpath):
    """A num- policy drawing the reference's workers (each round's one
    uploader), else None (the spec's own policy)."""
    if not spec.startswith("num-"):
        return None
    draws = ref_report.comm_mask.argmax(axis=1)
    inner = comm.make_policy(spec[len("num-"):].replace("iag", "gd"),
                             fastpath=fastpath)
    return ScheduledPolicy(inner, SampledSchedule(
        draw=lambda k: int(draws[k])))


@pytest.fixture
def xla_laq(monkeypatch):
    """LAQ's per-leaf encode with XLA-CPU's arithmetic: the step as
    scale × f32(1/qmax), the residual v − codes·step rounded once (an
    FMA; exact in float64 before the one rounding to float32)."""
    def step(scale, bits):
        recip = torch.tensor(1.0 / float(2 ** (bits - 1) - 1),
                             dtype=torch.float32)
        return scale.float() * recip

    def encode(g, q, e, scale, bits):
        qmax = float(2 ** (bits - 1) - 1)
        v = (g.float() - q.float()) + e.float()
        st = step(scale, bits)
        pos = st > 0.0
        inv = torch.where(pos, 1.0 / torch.where(pos, st,
                                                 torch.ones_like(st)),
                          torch.zeros_like(st))
        codes = torch.clamp(torch.round(v * inv), -qmax, qmax)
        p = codes * st
        resid = (v.double() - codes.double() * st.double()).float()
        return p, resid, torch.sum(p * p)

    monkeypatch.setattr(lag_ref, "quantizer_step", step)
    monkeypatch.setattr(lag_ref, "laq_encode", encode)


def masks_until(report, eps):
    k = report.iters_to(eps)
    return report.comm_mask[:(len(report.losses) if k is None else k + 1)]


# ---------------------------------------------------------------------------
# Repairs: float64 through the flat layout, the norms and the state
# ---------------------------------------------------------------------------

def test_layout_round_trips_float64_bitwise():
    tree = {"w": torch.tensor([1.0 + 2.0 ** -40, 3.0], dtype=torch.float64),
            "b": torch.tensor([2.0 ** -60], dtype=torch.float64)}
    lo = FlatLayout.for_tree(tree)
    buf = lo.flatten(tree)
    assert buf.dtype == torch.float64 == lo.dtype
    back = lo.unflatten(buf)
    for k in tree:
        assert back[k].dtype == torch.float64
        assert bits_equal(back[k].numpy(), tree[k].numpy())
    stacked = {k: torch.stack([v, 2 * v]) for k, v in tree.items()}
    sback = lo.unflatten_stacked(lo.flatten_stacked(stacked))
    for k in tree:
        assert bits_equal(sback[k].numpy(), stacked[k].numpy())
    # a float32 tree keeps float32 buffers, a bfloat16 or float16 tree
    # buffers of its own dtype (its leaves are views)
    for dt, want in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.float16, torch.float16)):
        lo = FlatLayout.for_tree({"w": torch.ones(3, dtype=dt)})
        assert lo.flatten({"w": torch.ones(3, dtype=dt)}).dtype \
            == want == lo.empty().dtype


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_tree_norms_accumulate_like_the_reference(dt):
    rng = np.random.default_rng(3)
    a = {"w": rng.standard_normal(300), "b": rng.standard_normal((7, 5))}
    b = {"w": rng.standard_normal(300), "b": rng.standard_normal((7, 5))}
    ta = {k: torch.from_numpy(v).to(dt) for k, v in a.items()}
    tb = {k: torch.from_numpy(v).to(dt) for k, v in b.items()}
    with jax.enable_x64(True):
        ja = {k: jnp.asarray(v, jdtype(dt)) for k, v in a.items()}
        jb = {k: jnp.asarray(v, jdtype(dt)) for k, v in b.items()}
        want_n = np.asarray(jlag.tree_sqnorm(ja))
        want_d = np.asarray(jlag.tree_sqnorm(jlag.tree_sub(ja, jb)))
    got_n, got_d = lag.tree_sqnorm(ta), lag.tree_sqdist(ta, tb)
    rtol = F64_RTOL if dt == torch.float64 else F32_RTOL
    for got, want in ((got_n, want_n), (got_d, want_d)):
        assert got.dtype == dt and str(want.dtype) == str(dt).split(".")[1]
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol)


def test_plain_route_keeps_each_state_dtype():
    """LAQ on a float64 tree: ĝ stays float64 (it absorbs the float32
    payload exactly), the residual float32, and the delta keeps the
    payload's float32, so the worker sum adds in float32 as the
    reference's."""
    W, d = 3, 50
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((W, d)))
    gh = torch.from_numpy(rng.standard_normal((W, d)) * (1 + 2.0 ** -30))
    lo = FlatLayout.for_tree(torch.zeros(d, dtype=torch.float64))
    pol = comm.make_policy("laq@4", fastpath=None)
    st = dict(pol.init_state(lo.flatten_stacked(gh)),
              hist=lag.hist_init(4, "cpu"))
    cfg = lag.LAGConfig(num_workers=W, alpha=0.1, D=4, xi=0.25)
    comm_m, delta, new = rounds.policy_rounds(
        pol, cfg, lo.empty(), lo.flatten_stacked(g), st, lo)
    assert comm_m.all()                          # empty history: RHS = 0
    assert new["grad_hat"].dtype == torch.float64
    assert new["resid"].dtype == delta.dtype == torch.float32
    for m in range(W):
        p, resid, _ = lag_ref.laq_encode(g[m], gh[m], torch.zeros(d),
                                         lag_ref.innovation_absmax(
                                             g[m], gh[m], torch.zeros(d)), 4)
        got = lo.unflatten(new["grad_hat"][m])
        assert bits_equal(got.numpy(), (gh[m] + p.double()).numpy())
        f32 = torch.float32
        assert bits_equal(lo.unflatten(new["resid"][m], like=f32).numpy(),
                          resid.numpy())
        assert bits_equal(lo.unflatten(delta[m], like=f32).numpy(),
                          p.numpy())


def test_make_policy_without_a_plan():
    for spec in ("gd", "lag-wk", "lag-ps", "laq@4", "lasg-wk", "cyc-iag",
                 "num-iag", "cyc-laq@4"):
        assert comm.make_policy(spec, fastpath=None).fastpath is None
    with pytest.raises(ValueError, match="fastpath mode"):
        comm.make_policy("lag-wk", fastpath="off")


# ---------------------------------------------------------------------------
# The problems
# ---------------------------------------------------------------------------

GENERATORS = {
    "synthetic-linreg": lambda m, dt, **kw: m.synthetic(
        "linreg", num_workers=9, dtype=dt, **kw),
    "synthetic-logreg": lambda m, dt, **kw: m.synthetic(
        "logreg", num_workers=6, n_per=30, d=20, lam=1e-2, seed=4, dtype=dt,
        **kw),
    "real-linreg": lambda m, dt, **kw: m.real_standin("linreg", dtype=dt,
                                                      **kw),
    "real-logreg": lambda m, dt, **kw: m.real_standin("logreg", lam=1e-3,
                                                      dtype=dt, **kw),
    "gisette": lambda m, dt, **kw: m.gisette_standin(n=300, d=64, dtype=dt,
                                                     **kw),
}


def both(name, dt):
    with jax.enable_x64(dt == torch.float64):
        jp = GENERATORS[name](jconvex, jdtype(dt))
        jp = jconvex.Problem(name=jp.name, kind=jp.kind,
                             X=np.asarray(jp.X), y=np.asarray(jp.y),
                             L_m=np.asarray(jp.L_m), L=jp.L, lam=jp.lam)
    return jp, GENERATORS[name](convex, dt, device="cpu")


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_are_bitwise_the_reference(name, dt):
    jp, p = both(name, dt)
    assert (p.name, p.kind, p.lam, p.L) == (jp.name, jp.kind, jp.lam, jp.L)
    for field in ("X", "y", "L_m"):
        got = getattr(p, field)
        assert got.dtype == dt
        assert bits_equal(got.numpy(), getattr(jp, field)), field


@pytest.mark.parametrize("name", ["synthetic-linreg", "synthetic-logreg",
                                  "real-logreg"])
def test_loss_and_gradients_match(name):
    jp, p = both(name, torch.float64)
    rng = np.random.default_rng(7)
    theta = rng.standard_normal(p.dim)
    thetas = rng.standard_normal((p.num_workers, p.dim))
    with jax.enable_x64(True):
        jq = jconvex.Problem(name=jp.name, kind=jp.kind, X=jnp.asarray(jp.X),
                             y=jnp.asarray(jp.y), L_m=jnp.asarray(jp.L_m),
                             L=jp.L, lam=jp.lam)
        fns = jax.jit(lambda t, ts: (jq.loss(t), jq.worker_grads(t),
                                     jq.worker_grads_at(ts)))
        want = [np.asarray(w) for w in fns(jnp.asarray(theta),
                                           jnp.asarray(thetas))]
    got = (p.loss(torch.from_numpy(theta)),
           p.worker_grads(torch.from_numpy(theta)),
           p.worker_grads_at(torch.from_numpy(thetas)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=F64_RTOL, atol=1e-12)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_optimum(dt):
    # linreg: numpy's closed form, bitwise
    jp, p = both("synthetic-linreg", dt)
    with jax.enable_x64(dt == torch.float64):
        jtheta, jloss = jconvex.Problem(
            name=jp.name, kind=jp.kind, X=jnp.asarray(jp.X),
            y=jnp.asarray(jp.y), L_m=jnp.asarray(jp.L_m), L=jp.L,
            lam=jp.lam).optimum()
        jtheta = np.asarray(jtheta)
    theta, loss = p.optimum()
    assert loss == jloss and bits_equal(theta.numpy(), jtheta)
    # logreg: `iters` GD steps at α = 1/L
    jp, p = both("synthetic-logreg", dt)
    with jax.enable_x64(dt == torch.float64):
        jtheta, jloss = jconvex.Problem(
            name=jp.name, kind=jp.kind, X=jnp.asarray(jp.X),
            y=jnp.asarray(jp.y), L_m=jnp.asarray(jp.L_m), L=jp.L,
            lam=jp.lam).optimum(iters=300)
        jtheta = np.asarray(jtheta)
    theta, loss = p.optimum(iters=300)
    rtol = F64_RTOL if dt == torch.float64 else F32_RTOL
    np.testing.assert_allclose(theta.numpy(), jtheta, rtol=rtol * 10,
                               atol=rtol)
    np.testing.assert_allclose(loss, jloss, rtol=rtol)


def test_generators_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        convex.synthetic("linreg")
    with pytest.raises(RuntimeError, match="cuda"):
        hetero_problem("linreg", h=0.5)


# ---------------------------------------------------------------------------
# SimWorkers in float32: every ALGOS entry, on the plain route and the
# plane (fastpath="on": the kernels' plain versions)
# ---------------------------------------------------------------------------

SPECS32 = simulate.ALGOS + ("laq@8", "cyc-laq@4")


@pytest.mark.parametrize("fastpath", [None, "on"])
@pytest.mark.parametrize("spec", SPECS32)
def test_sim_workers_float32(spec, fastpath, request):
    jp, opt, want = reference(spec, torch.float32, K32)
    p = fig3(torch.float32)
    laq = "laq" in spec
    if laq and fastpath is None:
        request.getfixturevalue("xla_laq")
    out = simulate.run(p, spec, K=K32, opt_loss=opt, fastpath=fastpath,
                       policy=injected(spec, want, fastpath or "auto"))
    assert out.losses.dtype == np.float32 and out.algo == spec
    assert out.bytes_per_upload == want.bytes_per_upload
    n, rtol = K32, F32_RTOL
    if laq and fastpath == "on":
        # the plane's LAQ divides exactly: held to the port's plain route,
        # which makes the same IEEE arithmetic on the same products
        want = simulate.run(p, spec, K=K32, opt_loss=opt)
    elif laq and not spec.startswith("cyc-"):
        # the two packages' float32 matrix products differ in the last
        # bit, and LAQ's codes turn that into whole quantizer steps (ROADMAP
        # queue 3, "LAQ code flips amplify"): losses within LAQ32_RTOL, and
        # the triggered masks, which differ from about round 25, through
        # the reference's iters_to(LAQ32_EPS)
        n, rtol = want.iters_to(LAQ32_EPS) + 1, LAQ32_RTOL
    assert np.array_equal(out.comm_mask[:n], want.comm_mask[:n])
    np.testing.assert_allclose(out.losses[:n], want.losses[:n], rtol=rtol)


# ---------------------------------------------------------------------------
# SimWorkers in float64: the Motivation table (Fig. 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", simulate.ALGOS)
def test_fig3_float64_reproduces_the_table(algo, request):
    jp, opt, want = reference(algo, torch.float64, K64)
    p = fig3(torch.float64)
    if algo == "laq":
        request.getfixturevalue("xla_laq")
    out = simulate.run(p, algo, K=K64, opt_loss=opt,
                       policy=injected(algo, want, None))
    assert out.losses.dtype == np.float64
    eps = 1e-8
    row = (out.iters_to(eps), out.comms_to(eps), out.bytes_to(eps),
           out.bytes_per_upload)
    assert row == TABLE[algo] == (want.iters_to(eps), want.comms_to(eps),
                                  want.bytes_to(eps), want.bytes_per_upload)
    ref_masks = masks_until(want, 1e-6)
    assert np.array_equal(out.comm_mask[:len(ref_masks)], ref_masks)
    k = want.iters_to(1e-6)
    np.testing.assert_allclose(out.losses[:k + 1], want.losses[:k + 1],
                               rtol=F64_RTOL)
    assert out.extras["L_m_spread"] == want.extras["L_m_spread"]
    assert out.extras["hetero_score"] == pytest.approx(HETERO[algo]) \
        == want.extras["hetero_score"]


def test_fig3_float64_laq_with_the_ports_own_arithmetic():
    """Without XLA-CPU's reciprocal step and fused residual, the port's
    IEEE LAQ reaches ε = 1e-8 in the reference's 65 rounds with 159
    uploads (the reference's XLA-CPU run: 162)."""
    _, opt, want = reference("laq", torch.float64, K64)
    out = simulate.run(fig3(torch.float64), "laq", K=100, opt_loss=opt)
    eps = 1e-8
    assert (out.iters_to(eps), out.comms_to(eps), out.bytes_to(eps)) \
        == (want.iters_to(eps), 159, 159 * 29.0)


@pytest.mark.parametrize("spec, dt, fastpath", [
    ("laq", torch.float64, None), ("laq", torch.float32, None),
    ("laq", torch.float32, "on"), ("laq@8", torch.float32, None)],
    ids=["laq-f64", "laq-f32", "laq-f32-plane", "laq@8-f32"])
def test_laq_with_the_ports_own_arithmetic_tracks_the_reference(
        spec, dt, fastpath):
    """The port's own LAQ (no XLA-CPU emulation) against the live
    reference: the same uploads through round LAQ_OWN_FIRST - 1 at least
    (measured: the first difference is round 25 for laq@4, 29 for laq@8,
    where a quantizer step's last bit flips a code), and every round's
    loss within LAQ32_RTOL (measured at most 5.9e-4).  In float64 the
    port still reaches ε = 1e-8 in the reference's rounds."""
    K = K64 if dt == torch.float64 else K32
    _, opt, want = reference(spec, dt, K)
    out = simulate.run(fig3(dt), spec, K=K, opt_loss=opt, fastpath=fastpath)
    differ = (out.comm_mask != want.comm_mask).any(axis=1).nonzero()[0]
    first = int(differ[0]) if differ.size else K
    assert first >= LAQ_OWN_FIRST, first
    np.testing.assert_allclose(out.losses, want.losses, rtol=LAQ32_RTOL)
    if dt == torch.float64:
        assert out.iters_to(1e-8) == want.iters_to(1e-8) == TABLE[spec][0]


@pytest.mark.parametrize("algo", ["gd", "lag-wk", "lag-ps"])
def test_logistic_float64_matches_the_reference(algo):
    """The logistic problems (Gisette's shape, cut to CPU size): the same
    masks and losses as the reference."""
    K, kw = 120, dict(n=300, d=64, dtype=None)
    with jax.enable_x64(True):
        jp = jconvex.gisette_standin(**dict(kw, dtype=jnp.float64))
        want = jsim.run(jp, algo, K=K, opt_loss=0.0)
    out = simulate.run(convex.gisette_standin(
        **dict(kw, dtype=torch.float64), device="cpu"), algo, K=K,
        opt_loss=0.0)
    assert np.array_equal(out.comm_mask, want.comm_mask)
    np.testing.assert_allclose(out.losses, want.losses, rtol=F64_RTOL)


# ---------------------------------------------------------------------------
# The convex servers, Experiment's validation, no plane for float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"server": "adam"},
                                {"server": "momentum@0.9"},
                                {"l1": 0.05}], ids=lambda kw: str(kw))
def test_convex_servers_float64(kw):
    K = 150
    _, opt, want = reference("lag-wk", torch.float64, K, **kw)
    out = simulate.run(fig3(torch.float64), "lag-wk", K=K, opt_loss=opt,
                       **kw)
    assert out.server == want.server
    assert np.array_equal(out.comm_mask, want.comm_mask)
    # Adam steps θ in float32, as the reference does, and XLA-CPU computes
    # its (μ̂/bc1)/den as μ̂/(bc1·den): float32 agreement
    rtol = F32_RTOL if kw.get("server") == "adam" else F64_RTOL
    np.testing.assert_allclose(out.losses, want.losses, rtol=rtol)


@pytest.mark.parametrize("kw, err, match", [
    ({}, ValueError, "exactly one of"),
    ({"problem": "P", "model": "llama3.2-1b"}, ValueError, "exactly one of"),
    ({"model": "llama3.2-1b"}, RuntimeError, "device='cpu'"),
    ({"problem": "P", "l1": 0.1, "server": "adam"}, ValueError,
     "conflicting server specs"),
    ({"problem": "P", "l1": 0.1, "algo": "lag-adam"}, ValueError,
     "conflicting server specs"),
    ({"problem": "P", "topology": "shards"}, ValueError, "'sim' topology"),
    ({"problem": "P", "topology": "pods:2"}, ValueError, "'sim' topology"),
    # ported since the gossip slice: it runs (err None: the topology the
    # report names); a node count that is not the worker count raises
    ({"problem": "P", "topology": "graph:9@ring"}, None, "graph"),
    ({"problem": "P", "topology": "graph:4@ring"}, ValueError,
     "worker i's shard"),
    ({"problem": "P", "topology": "sim@2"}, ValueError, "only 'async'"),
    # the unit count of 'sim:N' is ignored, as the reference ignores it:
    # the run is the 'sim' run
    ({"problem": "P", "topology": "sim:4"}, None, "sim"),
    ({"problem": "P", "algo": "iag"}, ValueError, "cyc-iag"),
    ({"problem": "P", "server": "sgd@1"}, ValueError, "no '@'"),
], ids=lambda v: str(v) if isinstance(v, dict) else "")
def test_experiment_validation(kw, err, match):
    if kw.get("problem") == "P":
        kw = dict(kw, problem=fig3(torch.float64))
    if err is None:
        r = Experiment(steps=2, opt_loss=1.0, **kw).run()
        if match == "sim":
            want = Experiment(steps=2, opt_loss=1.0,
                              **dict(kw, topology="sim")).run()
            assert r.topology == want.topology == "sim"
            assert np.array_equal(r.comm_mask, want.comm_mask)
            assert np.array_equal(r.losses, want.losses)
            return
        assert r.topology == match and r.comm_mask.shape == (2, 18)
        return
    with pytest.raises(err, match=match):
        Experiment(steps=2, opt_loss=1.0, **kw).run()


def test_float64_never_reaches_the_plane():
    p = fig3(torch.float64)
    assert Experiment(problem=p)._plane_mode() is None
    assert Experiment(problem=p, fastpath="auto")._plane_mode() is None
    assert Experiment(problem=fig3(torch.float32))._plane_mode() == "auto"
    with pytest.raises(ValueError, match="cannot serve"):
        simulate.run(p, "lag-wk", K=2, opt_loss=1.0, fastpath="on")
    with pytest.raises(ValueError, match="fastpath mode"):
        simulate.run(p, "lag-wk", K=2, opt_loss=1.0, fastpath="off")
