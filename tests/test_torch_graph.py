"""The port's serverless gossip plane (``repro_torch.graph``) held against
the LIVE JAX reference (``repro.graph``).

  * the spec (``build_graph``): adjacency, edge lists, mixing matrix and
    spectral gap bitwise the reference's for every family, and for three
    seeds of the seeded families; ``make_topology``'s graph grammar and its
    rejects, message for message (the list of tests/test_engine.py);
  * the convex run on the reference's ``prob9`` (linreg, W 9, n_per 20,
    d 10) over ring / torus:3x3 / complete × every policy family (num-iag
    on the reference's injected draws): float64 on the plain route with
    equal masks and losses within rtol 1e-10, float32 on the forced plane
    with masks equal through iters_to(1e-2) and losses within rtol 1e-4.
    Two reference behaviours are lifted for the float64 bound, each a
    known difference (ROADMAP queue 3): the reference stores every edge
    mirror in float32 between rounds (``FlatLayout.pack_stacked``), and
    its LAQ quantizer is XLA-CPU's (the ``xla_laq`` fixture of
    tests/test_torch_convex.py).  Against the reference as it is, the
    masks are equal and the losses within rtol 1e-6 (measured: 1.9e-7 in
    200 rounds), the size of that float32 store;
  * the deep step on the reduced llama3.2-1b (``graph:2@complete`` at ξ
    0.1 where every edge uploads, ``graph:4@ring`` at ξ 10 where edges go
    quiet; gd, lag-wk, lag-ps, laq@4; 3 rounds; plain route and forced
    plane): masks equal, losses within rtol 1e-5, θ within rtol 1e-4 (atol
    1e-6) — for laq@4 outside the few coordinates whose 4-bit code flips
    at a rounding boundary (measured: ≤ 0.13 % of a leaf, 0.02 % of θ,
    each off by at most 5.6e-3; held to the bounds of
    tests/test_torch_trainer.py, 0.6 % / 0.1 % / 6e-3);
  * the mixing order, the front doors (``Experiment`` priced per edge, the
    launcher's ``--topology graph:4@ring --cluster``) and the errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.configs import get_config as jget_config
from repro.core import convex as jconvex
from repro.data import TokenStream as JTokenStream
from repro.data import make_heterogeneous_inputs as jmake_hetero
from repro.dist import TrainerConfig as JTrainerConfig
from repro.engine import Experiment as JExperiment
from repro.engine.topology import make_topology as jmake_topology
from repro.fastpath import layout as jlayout

from repro_torch import comm, graph
from repro_torch.comm import SampledSchedule, ScheduledPolicy
from repro_torch.configs import get_config
from repro_torch.core import convex, lag
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream, make_heterogeneous_inputs
from repro_torch.dist.lag_trainer import TrainerConfig, param_layout
from repro_torch.engine import Experiment, make_server, make_topology
from repro_torch.kernels.lag_trigger import ref as lag_ref
from repro_torch.launch import train as launch_train
from repro_torch.netsim import make_cluster, price_edge_mask
from repro_torch.weights import params_from_reference

W = 9
FAMILIES = ("ring", "torus:3x3", "complete", "expander:4",
            "smallworld:4@0.2")
RUN_FAMILIES = ("ring", "torus:3x3", "complete")
ALGOS = ("gd", "lag-wk", "lag-ps", "laq@4", "lasg-wk", "cyc-iag", "num-iag")
K64, K32 = 30, 15
F64_RTOL, F32_RTOL, F32_EPS = 1e-10, 1e-4, 1e-2
AS_IS_RTOL = 1e-6
DEEP_LOSS_RTOL = 1e-5
LAQ_FLIP_SHARE, LAQ_LEAF_FLIP_SHARE, LAQ_MAX_DTHETA = 1e-3, 6e-3, 6e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the rounds are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# The spec and the grammar
# ---------------------------------------------------------------------------

SPEC_CASES = [(f, 0) for f in FAMILIES] + [
    (f, s) for f in ("expander:4", "smallworld:4@0.2") for s in (1, 7)] + [
    ("ring", 0, 2), ("complete", 0, 2), ("torus:3x4", 0, 12),
    ("expander:3", 5, 16), ("smallworld:6@0.5", 2, 16)]


@pytest.mark.parametrize("case", SPEC_CASES, ids=str)
def test_spec_is_bitwise_the_reference(case):
    family, seed = case[:2]
    nodes = case[2] if len(case) > 2 else W
    got = graph.build_graph(nodes, family, seed=seed)
    want = jgraph.build_graph(nodes, family, seed=seed)
    for attr in ("adj", "mixing", "edge_src", "edge_dst", "edge_weights",
                 "self_weights", "degrees"):
        assert bits_equal(getattr(got, attr), getattr(want, attr)), attr
    assert got.spectral_gap == want.spectral_gap
    assert (got.num_edges, got.family, got.seed) \
        == (want.num_edges, want.family, want.seed)


GOOD_SPECS = ("graph:9@ring", "graph:2@complete", "graph:4@ring",
              "graph:12@torus:3x4", "graph:16@expander:4",
              "graph:16@smallworld:4@0.2", " graph:9@ring ")


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_make_topology_builds_the_reference_graph(spec):
    got, want = make_topology(spec), jmake_topology(spec)
    assert (got.name, got.kind) == (want.name, want.kind) == ("graph",
                                                              "deep")
    assert (got.num_nodes, got.num_edges, got.units(3), got.family) \
        == (want.num_nodes, want.num_edges, want.units(3), want.family)
    assert bits_equal(got.spec.adj, want.spec.adj)
    assert make_topology(got) is got


# tests/test_engine.py's graph rejects, each matched message for message
BAD_SPECS = ("graph", "graph:8", "graph:x@ring", "graph:1@ring",
             "graph:8@warp", "graph:8@ring:3", "graph:8@torus:3x3",
             "graph:6@torus:x2", "graph:4@torus:1x4", "graph:8@expander:0",
             "graph:8@expander:9", "graph:8@expander:z",
             "graph:5@expander:3", "graph:8@smallworld:4",
             "graph:8@smallworld:3@0.1", "graph:8@smallworld:4@1.5",
             "graph:8@smallworld:4@x", "graph:@ring", "graph:8@")


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_graph_rejects_match_the_reference(spec):
    with pytest.raises(ValueError) as got:
        make_topology(spec)
    with pytest.raises(ValueError) as want:
        jmake_topology(spec)
    assert str(got.value) == str(want.value)
    assert "graph:<nodes>@<family>" in str(got.value)


def test_devices_alone_is_not_ported():
    """Every reference topology is ported now: ``devices:2`` builds the
    device plane's topology, with the reference's name and unit count.
    (The name is kept from when ``devices`` raised, so that the test's
    history stays one.)"""
    got, want = make_topology("devices:2"), jmake_topology("devices:2")
    assert (got.name, got.num_devices(), got.units(4)) \
        == (want.name, want.num_devices(), want.units(4))


# ---------------------------------------------------------------------------
# The mixing step
# ---------------------------------------------------------------------------

def test_mixing_adds_the_in_edges_first_then_the_own_term():
    """Own term 1.0 and two in-edge products of 2^-24 (half an ulp of 1):
    summed first they make 2^-23 and move the result; folded into the own
    term one by one each rounds away.  The port equals the reference's
    ``segment_sum`` mixing bit for bit, and differs from the fold."""
    spec = graph.build_graph(3, "complete")      # every node: 2 in-edges
    edges = graph.EdgeMap.of(spec, torch.float32, "cpu")
    psi = torch.full((3, 8, 128), 1.0) / edges.self_w.view(3, 1, 1)
    own = psi * edges.self_w.view(3, 1, 1)
    mirrors = torch.full((spec.num_edges, 8, 128), 2.0 ** -24) \
        / edges.edge_w.view(-1, 1, 1)
    got = graph.mix(psi, mirrors, edges)
    want = np.asarray(jgraph.mix(
        jnp.asarray(psi.numpy()), jnp.asarray(mirrors.numpy()),
        jnp.asarray(spec.self_weights, jnp.float32),
        jnp.asarray(spec.edge_weights, jnp.float32),
        jnp.asarray(spec.edge_dst), 3))
    assert bits_equal(got.numpy(), want)
    folded = own.clone()
    for e, i in enumerate(spec.edge_dst):
        folded[i] += mirrors[e] * edges.edge_w[e]
    assert not torch.equal(got, folded)
    # in place: θ' into ψ's buffer, the products into the scratch buffer
    scratch = torch.empty_like(mirrors)
    out = graph.mix(psi.clone(), mirrors, edges, scratch=scratch)
    assert torch.equal(out, got)


# ---------------------------------------------------------------------------
# The convex run against the reference
# ---------------------------------------------------------------------------

@pytest.fixture
def xla_laq(monkeypatch):
    """LAQ's per-leaf encode with XLA-CPU's arithmetic (as in
    tests/test_torch_convex.py): the step as scale × f32(1/qmax), the
    residual v − codes·step rounded once."""
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


def _lifted_pack(self, tree):
    """The reference's ``pack_stacked`` without its float32 cast: under
    x64 every packed mirror keeps float64."""
    leaves = jax.tree_util.tree_leaves(tree)
    n = leaves[0].shape[0]
    segs = []
    for l, size, lanes in zip(leaves, self.sizes, self.leaf_lanes):
        flat = l.reshape((n, size)).astype(jnp.float64)
        pad = lanes * jlayout.LANES - size
        segs.append(jnp.pad(flat, [(0, 0), (0, pad)]) if pad else flat)
    return jnp.concatenate(segs, axis=1)


_REF = {}


def reference_run(dt, family, algo, K, lifted):
    """(opt_loss, report) of the live reference on prob9 (cached)."""
    key = (str(dt), family, algo, K, lifted)
    if key not in _REF:
        x64 = dt == torch.float64
        with jax.enable_x64(x64):
            jp = jconvex.synthetic("linreg", num_workers=W, n_per=20, d=10,
                                   seed=0, dtype=jnp.float64 if x64
                                   else jnp.float32)
            _, opt = jp.optimum()
            pack = jlayout.FlatLayout.pack_stacked
            if lifted:
                jlayout.FlatLayout.pack_stacked = _lifted_pack
            try:
                rep = JExperiment(problem=jp, algo=algo, steps=K,
                                  topology=f"graph:{W}@{family}",
                                  opt_loss=opt).run()
            finally:
                jlayout.FlatLayout.pack_stacked = pack
        _REF[key] = (float(opt), rep)
    return _REF[key]


def prob9(dt):
    return convex.synthetic("linreg", num_workers=W, n_per=20, d=10, seed=0,
                            dtype=dt, device="cpu")


def port_run(dt, family, algo, K, want, fastpath=None, **kw):
    """The port's Experiment on prob9; a num- algo draws the reference's
    edges (each round's one uploader)."""
    pol = None
    if algo.startswith("num-"):
        draws = want.comm_mask.argmax(axis=1)
        pol = ScheduledPolicy(
            comm.make_policy(algo[4:].replace("iag", "gd"),
                             fastpath=fastpath),
            SampledSchedule(draw=lambda k: int(draws[k])))
    return Experiment(problem=prob9(dt), algo=algo, steps=K,
                      topology=f"graph:{W}@{family}", opt_loss=want.opt_loss,
                      fastpath=fastpath, policy=pol, **kw).run()


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("family", RUN_FAMILIES)
def test_convex_float64_matches_reference(family, algo, xla_laq):
    _, want = reference_run(torch.float64, family, algo, K64, lifted=True)
    got = port_run(torch.float64, family, algo, K64, want)
    assert np.array_equal(got.comm_mask, want.comm_mask)
    np.testing.assert_allclose(got.losses, want.losses, rtol=F64_RTOL)
    assert got.losses.dtype == np.float64
    for k in ("num_nodes", "num_edges", "graph_family", "spectral_gap",
              "trigger_rhs_underflow_rounds", "L_m_spread", "hetero_score"):
        assert got.extras[k] == want.extras[k], k
    assert bits_equal(got.extras["edge_src"], want.extras["edge_src"])
    assert bits_equal(got.extras["edge_dst"], want.extras["edge_dst"])
    # the nodes' disagreement: round-off level (1e-31) on the complete
    # graph, where every node holds the same iterate
    np.testing.assert_allclose(got.extras["consensus_final"],
                               want.extras["consensus_final"], rtol=1e-8,
                               atol=1e-20)
    assert got.bytes_per_upload == want.bytes_per_upload
    assert got.topology == "graph" and got.algo == algo


@pytest.mark.parametrize("algo", ["lag-wk", "lag-ps", "cyc-iag"])
def test_convex_float64_against_the_reference_as_it_is(algo):
    """The reference keeps its edge mirrors in float32 between rounds; the
    port keeps the problem's dtype.  Same masks; losses apart by the
    float32 store's rounding."""
    _, want = reference_run(torch.float64, "ring", algo, K64, lifted=False)
    got = port_run(torch.float64, "ring", algo, K64, want)
    assert np.array_equal(got.comm_mask, want.comm_mask)
    np.testing.assert_allclose(got.losses, want.losses, rtol=AS_IS_RTOL)
    assert not np.array_equal(got.losses, want.losses)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("family", RUN_FAMILIES)
def test_convex_float32_plane_matches_reference(family, algo):
    _, want = reference_run(torch.float32, family, algo, K32, lifted=False)
    got = port_run(torch.float32, family, algo, K32, want, fastpath="on")
    k = want.iters_to(F32_EPS)
    n = K32 if k is None else k + 1
    assert np.array_equal(got.comm_mask[:n], want.comm_mask[:n])
    np.testing.assert_allclose(got.losses[:n], want.losses[:n],
                               rtol=F32_RTOL)


def test_complete_graph_gd_is_the_ports_centralized_gd():
    """Uniform mixing (1/W) makes every node's iterate the centralized one:
    the consensus trajectory is sim's gd at the same α (the reference's
    rtol 1e-4; float reassociation in the average is the only daylight)."""
    p = prob9(torch.float32)
    a = 1.0 / (W * float(torch.max(p.L_m)))
    rg = Experiment(problem=p, algo="gd", steps=60, alpha=a,
                    topology=f"graph:{W}@complete", opt_loss=0.0).run()
    rc = Experiment(problem=p, algo="gd", steps=60, alpha=a,
                    opt_loss=0.0).run()
    np.testing.assert_allclose(rg.losses, rc.losses, rtol=1e-4)
    assert rg.comm_mask.all()
    assert rg.comm_mask.shape == (60, rg.extras["num_edges"]) == (60, 72)


def _quiet_problem():
    """Zero data: every gradient is 0, every adapt the identity, every
    edge innovation 0 — the strict trigger never fires."""
    d = 4
    return convex.Problem(name="quiet", kind="linreg",
                          X=torch.zeros((W, 2, d)), y=torch.zeros((W, 2)),
                          L_m=torch.ones((W,)), L=1.0)


@pytest.mark.parametrize("family", FAMILIES)
def test_all_quiet_rounds_move_zero_bytes(family):
    K = 8
    r = Experiment(problem=_quiet_problem(), algo="lag-wk", steps=K,
                   topology=f"graph:{W}@{family}", opt_loss=0.0).run()
    E = r.extras["num_edges"]
    assert r.comm_mask.shape == (K, E) and int(r.comm_mask.sum()) == 0
    assert float(r.cum_wire_bytes[-1]) == 0.0
    cl = make_cluster(f"hetero:{E}@10ms/1Gbps")
    args = (r.bytes_per_upload, cl, r.extras["edge_dst"])
    priced = price_edge_mask(r.comm_mask, *args)
    assert np.array_equal(priced, price_edge_mask(np.zeros((K, E), bool),
                                                  *args))
    assert (priced < price_edge_mask(np.ones((K, E), bool), *args)).all()


def test_experiment_prices_per_edge_as_the_reference():
    _, want = reference_run(torch.float32, "ring", "lag-wk", 20,
                            lifted=False)
    cluster = "hetero:18@10ms/1Gbps"
    with jax.enable_x64(False):
        jp = jconvex.synthetic("linreg", num_workers=W, n_per=20, d=10,
                               seed=0)
        jr = JExperiment(problem=jp, algo="lag-wk", steps=20,
                         topology=f"graph:{W}@ring", cluster=cluster,
                         opt_loss=want.opt_loss).run()
    got = port_run(torch.float32, "ring", "lag-wk", 20, want,
                   cluster=cluster)
    assert np.array_equal(got.comm_mask, jr.comm_mask)
    assert bits_equal(got.round_seconds, np.asarray(jr.round_seconds))
    assert got.wall_seconds == jr.wall_seconds > 0
    assert got.extras["cluster"] == jr.extras["cluster"] == "hetero"


def test_node_count_mismatch_raises_the_references_message():
    msgs = []
    for exp, prob in ((Experiment, prob9(torch.float64)),
                      (JExperiment, jconvex.synthetic(
                          "linreg", num_workers=W, n_per=20, d=10))):
        with pytest.raises(ValueError) as e:
            exp(problem=prob, algo="gd", steps=2,
                topology="graph:4@ring").run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "node i holds worker i's shard" in msgs[0]


def test_policy_without_grad_hat_raises_the_references_message():
    class NoMirror(comm.GDPolicy):
        state_keys = ()

    cfg = lag.LAGConfig(num_workers=W, alpha=0.01, D=10, xi=0.1)
    p = convex.synthetic("linreg", num_workers=W, n_per=4, d=3,
                         device="cpu")
    with pytest.raises(ValueError) as got:
        graph.run_convex(p, NoMirror(fastpath=None), make_server("sgd"), cfg,
                         make_topology(f"graph:{W}@ring"), K=2)
    assert "'grad_hat' mirror" in str(got.value)
    assert "state_keys=()" in str(got.value)


def test_edge_state_starts_at_theta0_in_buffers_of_its_own():
    pol = comm.make_policy("lag-ps", fastpath="on")
    theta0 = torch.arange(2 * 128, dtype=torch.float32).view(2, 128)
    st = graph.init_edge_state(pol, theta0, 4, D=10)
    gh, th = st["edge_grad_hat"], st["edge_theta_hat"]
    assert gh.shape == th.shape == (4, 2, 128)
    assert all(torch.equal(gh[e], theta0) for e in range(4))
    assert gh.data_ptr() != th.data_ptr()
    assert st["comm_per_worker"].shape == (4,) and int(st["comm_total"]) == 0


# ---------------------------------------------------------------------------
# The deep step against the reference
# ---------------------------------------------------------------------------

DEEP_CASES = [("graph:2@complete", 0.1), ("graph:4@ring", 10.0)]
DEEP_ALGOS = ("gd", "lag-wk", "lag-ps", "laq@4")
DEEP_LR, SEQ = 0.3, 16


@pytest.fixture(scope="module")
def cfgs():
    return jget_config("llama3.2-1b").reduced(), \
        get_config("llama3.2-1b").reduced()


_DEEP = {}


def deep_reference(cfgs, spec, xi, algo):
    """3 rounds of the reference's jitted graph step (cached): its initial
    node-0 parameters, losses, masks, final stacked parameters, batch."""
    key = (spec, xi, algo)
    if key not in _DEEP:
        jcfg, _ = cfgs
        topo = jmake_topology(spec)
        n = topo.num_nodes
        jt = JTrainerConfig(algo=algo, num_workers=n, lr=DEEP_LR, xi=xi)
        st = jgraph.init_graph_state(jax.random.PRNGKey(0), jcfg, jt, topo)
        p0 = jax.tree_util.tree_map(lambda l: np.asarray(l[0]),
                                    st["params"])
        step = jax.jit(jgraph.make_graph_step(jcfg, jt, topo))
        batch = jmake_hetero(jcfg, JTokenStream(jcfg.vocab_size), 0, n,
                             2 * n, SEQ)
        losses, masks = [], []
        for _ in range(3):
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
            masks.append(np.asarray(m["comm_mask"]).tolist())
        _DEEP[key] = (p0, losses, masks, jax.tree_util.tree_map(
            np.asarray, st["params"]), int(st["lag"]["comm_total"]))
    return _DEEP[key]


@pytest.mark.parametrize("route", ["plain", "plane"])
@pytest.mark.parametrize("algo", DEEP_ALGOS)
@pytest.mark.parametrize("spec, xi", DEEP_CASES)
def test_deep_step_matches_reference(cfgs, spec, xi, algo, route):
    p0, want_l, want_m, want_th, want_total = deep_reference(cfgs, spec, xi,
                                                             algo)
    _, cfg = cfgs
    topo = make_topology(spec)
    n = topo.num_nodes
    tcfg = TrainerConfig(algo=algo, num_workers=n, lr=DEEP_LR, xi=xi,
                         fastpath="on" if route == "plane" else "auto")
    state = graph.init_graph_state(
        cfg, tcfg, topo, device="cpu",
        params=params_from_reference(p0, cfg, device="cpu"))
    step = graph.make_graph_step(cfg, tcfg, topo)
    batch = make_heterogeneous_inputs(cfg, TokenStream(cfg.vocab_size), 0,
                                      n, 2 * n, SEQ, device="cpu")
    losses, masks = [], []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        masks.append(m["comm_mask"].tolist())
        assert m["comm_mask"].shape == (topo.num_edges,)
    assert masks == want_m
    np.testing.assert_allclose(losses, want_l, rtol=DEEP_LOSS_RTOL)
    assert int(state["lag"]["comm_total"]) == want_total
    if xi == 10.0 and algo != "gd":
        # the quiet regime this case was chosen for: edges skip
        assert any(not all(r) for r in masks)
    lo = param_layout(cfg)
    flips, size = 0, 0
    for a, b in zip(tree_leaves(lo.unflatten_stacked(state["theta"])),
                    jax.tree_util.tree_leaves(want_th)):
        a, b = a.numpy(), np.asarray(b)
        if not algo.startswith("laq"):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
            continue
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
        assert off.sum() <= LAQ_LEAF_FLIP_SHARE * a.size
        assert np.all(np.abs(a - b) <= LAQ_MAX_DTHETA)
        flips, size = flips + int(off.sum()), size + a.size
    assert flips <= LAQ_FLIP_SHARE * size


def test_deep_step_state_and_memory_contract(cfgs):
    """θ is one stacked (W, rows, 128) buffer, the mirrors (E, rows, 128)
    buffers advanced in place; the step returns θ' in a new buffer."""
    _, cfg = cfgs
    topo = make_topology("graph:4@ring")
    tcfg = TrainerConfig(algo="laq@4", num_workers=4, lr=DEEP_LR,
                         fastpath="on")
    st = graph.init_graph_state(cfg, tcfg, topo, device="cpu", seed=1)
    lo = param_layout(cfg)
    assert st["theta"].shape == (4, lo.rows, 128)
    assert st["lag"]["edge_grad_hat"].shape == (8, lo.rows, 128)
    assert st["lag"]["edge_resid"].dtype == torch.float32
    gh = st["lag"]["edge_grad_hat"]
    theta = st["theta"]
    batch = make_heterogeneous_inputs(cfg, TokenStream(cfg.vocab_size), 0,
                                      4, 8, 16, device="cpu")
    new, m = graph.make_graph_step(cfg, tcfg, topo)(st, batch)
    assert new["lag"]["edge_grad_hat"] is gh
    assert new["theta"] is not theta and new["step"] == 1
    assert m["wire_bytes_this_round"] == 8 * tcfg.comm_policy().wire_bytes(
        graph.node_params(new, cfg))


# ---------------------------------------------------------------------------
# The front doors
# ---------------------------------------------------------------------------

def test_cli_graph_prices_per_edge(capsys):
    state = launch_train.main(
        ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4",
         "--seq", "16", "--lr", "0.3", "--fastpath", "on", "--topology",
         "graph:4@ring", "--cluster", "hetero:8@10ms/1Gbps"])
    out = capsys.readouterr().out
    assert state["theta"].shape[0] == 4
    assert state["lag"]["comm_per_worker"].shape == (8,)
    masks = [line.split(" mask ")[1].split(" |")[0]
             for line in out.splitlines() if line.startswith("step ")]
    assert len(masks) == 3 and all(m.count(",") == 7 for m in masks)
    assert "vs GD 24 " in out                    # 3 rounds × 8 edges
    assert "simulated wall-clock on 'hetero:8@10ms/1Gbps'" in out
    with pytest.raises(ValueError, match="8"):
        # the cluster is sized to the E directed edges, not the W nodes
        launch_train.main(["--reduced", "--device", "cpu", "--steps", "1",
                           "--topology", "graph:4@ring", "--cluster",
                           "hetero:4@10ms/1Gbps"])


def test_experiment_model_graph_extras():
    r = Experiment(model="llama3.2-1b", algo="lag-wk",
                   topology="graph:4@ring", steps=2, lr=0.3, batch=4,
                   seq=16, device="cpu", fastpath="on",
                   cluster="hetero:8@10ms/1Gbps").run()
    assert r.comm_mask.shape == (2, 8) and r.topology == "graph"
    assert r.extras["num_nodes"] == 4 and r.extras["graph_family"] == "ring"
    assert r.extras["edge_dst"].tolist() == [1, 3, 0, 2, 1, 3, 0, 2]
    assert r.round_seconds.shape == (2,) and r.wall_seconds > 0


def test_params_from_reference_needs_a_gpu_unless_asked_for_cpu(cfgs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg, cfg = cfgs
    p0 = deep_reference(cfgs, "graph:2@complete", 0.1, "gd")[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(p0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_reference(p0, cfg, device="cuda")
    out = params_from_reference(p0, cfg, device="cpu")
    assert all(l.device.type == "cpu" for l in tree_leaves(out))
