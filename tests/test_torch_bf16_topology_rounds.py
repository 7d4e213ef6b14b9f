"""The ``pods``, ``async`` and ``fleet`` rounds at bfloat16 alone, against
the LIVE JAX reference, and the port's own identities at bfloat16.

The round alone (W = 3, the plane ``fastpath="on"`` and the plain route
``"auto"``), fed numpy-seeded gradients, mirrors and θ of an all-bfloat16
tree and of a tree of bfloat16 and float32 leaves (``test_torch_mixed_
round.SPEC``), each LHS far from its RHS, through the reference's jitted
round and the port's:

- pods: the round with ``PodMesh.reduce_fn``, a round where some worker
  uploads and an all-quiet one (the zero branch: zeros at each part's
  dtype, ∇ unchanged);
- async: the stale views of a ``(τ+1)``-deep ring (τ = 2: the ring is the
  view; τ = 1: a gather), the round at those views, the ring's push;
- fleet: the cohort's float32 compact rows gathered into plane buffers
  (exactly: the rows only hold values of the plane's dtypes), the round,
  the scatter back (a dropout's row kept bit for bit), N = 5, k = 3.

Masks, ĝ, θ̂, ∇, the ring and the compact rows equal the reference's
oracle route bit for bit, but for the fleet's uploaders' ĝ rows: XLA fuses
ĝ + (g − ĝ) into its float32 scatter without the bfloat16 roundings, and
the port's row is within ½ ulp(g − ĝ) + ½ ulp(ĝ) of it at bfloat16
(ROADMAP queue 3 (a)); θ bitwise on its bfloat16 leaves, its float32
leaves within rtol = atol = 1e-6 (XLA fuses θ − α·∇ into a multiply-add);
the history (a sum over the leaves) within rtol 1e-6, as
``test_torch_mixed_round.py`` holds it; the fleet's innovation score
within rtol 1e-5 (the sum's order).

The identities (no reference: its laq@4 does not run on pods and the
fleet at bfloat16, ROADMAP queue 3): ``pods:2`` (one fixed batch at lr
0.005, two quiet rounds), ``async:2@0`` and ``fleet:2@2`` (a fresh batch a
round at lr 0.3) are bitwise the port's ``shards`` for lag-wk, lag-ps and
laq@4 on the reduced bfloat16 llama (plane, plain and legacy routes) and
mamba2 (plane).
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro import fleet as jfleet
from repro.core import lag as jlag
from repro.engine import rounds as jrounds
from repro.engine import server as jserver
from repro.engine import topology as jtopology
from repro.fleet import rounds as jfleet_rounds

from repro_torch import comm, fleet
from repro_torch.configs import get_config
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves
from repro_torch.data import (TokenStream, make_heterogeneous_inputs,
                              make_inputs)
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step, param_layout)
from repro_torch.engine import make_topology, rounds, server
from repro_torch.engine.topology import AsyncShards, PodMesh
from repro_torch.fastpath.layout import (MixedLayout, dtype_of, layout_for,
                                         parts_of, row)
from repro_torch.fleet import FleetTopology
from repro_torch.fleet.population import MIRROR_PREFIX, Population
from repro_torch.fleet.rounds import fleet_round

from test_torch_mixed_round import (SPEC, W, bitwise, single, stack, to_t,
                                    tt, ulp, within)

BF, F32 = ml_dtypes.bfloat16, np.float32
#: the all-bfloat16 tree: the mixed tree's shapes, every leaf bfloat16
SPECS = {"bf16": jax.tree_util.tree_map(
    lambda s: (s[0], BF), SPEC, is_leaf=lambda x: isinstance(x, tuple)),
    "mixed": SPEC}
#: float32 θ leaves against XLA's fused multiply-add
F32_RTOL = 1e-6
INNOV_RTOL = 1e-5
N_POP, COHORT = 5, (0, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its rounds are many small
    ops, which several test processes' thread pools slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Round inputs
# ---------------------------------------------------------------------------

def np_tree(kind, lead=(), seed=0, scale=1.0, dt=None):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(lead + (s[0],))).astype(
            F32).astype(dt or s[1]), SPECS[kind],
        is_leaf=lambda x: isinstance(x, tuple))


def near(kind, tree, seed, s):
    """``tree`` minus noise of size s_i along its leading axis, at each
    leaf's dtype."""
    n = len(s)
    noise = np_tree(kind, (n,), seed, dt=F32)
    return jax.tree_util.tree_map(
        lambda x, z: (x.astype(F32) - np.asarray(s, F32).reshape(
            (n,) + (1,) * (z.ndim - 1)) * z).astype(x.dtype), tree, noise)


def lead(tree, n):
    return jax.tree_util.tree_map(lambda t: np.broadcast_to(t, (n,) +
                                                            t.shape), tree)


@functools.lru_cache(maxsize=None)
def round_inputs(kind, spec, quiet=False):
    """(grads, state, θ, ∇, hist): worker 1 close to its mirror and the
    others far, or every worker close (``quiet``)."""
    grads = np_tree(kind, (W,), 1)
    st = {"grad_hat": near(kind, grads, 2,
                           (0.01,) * 3 if quiet else (1.0, 0.01, 1.0))}
    theta = np_tree(kind, (), 3)
    if spec == "lag-ps":
        st["theta_hat"] = near(kind, lead(theta, W), 4, (0.0005,) * 3
                               if quiet else (0.05, 0.0005, 0.05))
    nabla = jax.tree_util.tree_map(
        lambda x, t: np.sum(x.astype(F32), 0).astype(t.dtype),
        st["grad_hat"], theta)
    hist = np.full((4,), 0.03 if spec == "lag-ps" and not quiet else 3.0,
                   F32)
    return grads, st, theta, nabla, hist


def lag_config(pkg, spec, n=W):
    return pkg.LAGConfig(num_workers=n, alpha=0.1, D=4, xi=0.25,
                         rule="ps" if spec == "lag-ps" else "wk")


def ref_lag_state(inputs, n=W):
    _, st, _, nabla, hist = inputs
    return dict(st, nabla=nabla, hist=hist,
                L_m=np.full((W,), 10.0, F32), comm_total=np.int32(0),
                comm_per_worker=np.zeros(n, np.int32))


def port_lag_state(lo, inputs, n=W):
    _, st, _, nabla, hist = inputs
    ls = {k: stack(lo, v) for k, v in st.items()}
    ls.update(nabla=single(lo, nabla), hist=torch.from_numpy(hist.copy()),
              L_m=torch.full((W,), 10.0),
              comm_total=torch.zeros((), dtype=torch.int32),
              comm_per_worker=torch.zeros(n, dtype=torch.int32))
    return ls


def stack_n(lo, tree, n):
    """A reference tree stacked over n as the port's (n, rows, 128)
    buffer(s), each part at its leaves' dtype."""
    buf = lo.empty((n,))
    t = tt(tree)
    for i in range(n):
        lo.flatten(jax.tree_util.tree_map(lambda x: x[i], t), out=row(buf, i))
    return buf


def rows_of(lo, buf, n):
    """The port's stacked buffer(s) as leaves stacked over n."""
    per = [tree_leaves(lo.unflatten(row(buf, i), like=dtype_of(buf)))
           for i in range(n)]
    return [torch.stack([p[j] for p in per]) for j in range(lo.num_leaves)]


def leaves(lo, buf):
    return tree_leaves(lo.unflatten(buf, like=dtype_of(buf)))


def ref_leaves(tree):
    return [to_t(x) for x in jax.tree_util.tree_leaves(tree)]


def check_theta(got, want, what):
    """θ-derived leaves: bitwise at bfloat16, float32 within F32_RTOL."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=F32_RTOL, atol=F32_RTOL)
        else:
            bitwise(g, w, f"{what}[{i}]")


def check_round(lo, port, ref):
    """Masks, ĝ, θ̂, ∇ bitwise, θ by ``check_theta``, the history."""
    theta, ls, m = port
    jtheta, jls, jm = ref
    np.testing.assert_array_equal(m["comm_mask"].numpy(), jm["comm_mask"])
    for key in ("grad_hat", "theta_hat"):
        if key in ls:
            for i, (g, w) in enumerate(zip(rows_of(lo, ls[key], W),
                                           ref_leaves(jls[key]))):
                bitwise(g, w, f"{key}[{i}]")
    for i, (g, w) in enumerate(zip(leaves(lo, ls["nabla"]),
                                   ref_leaves(jls["nabla"]))):
        bitwise(g, w, f"nabla[{i}]")
    check_theta(leaves(lo, theta), ref_leaves(jtheta), "theta")
    np.testing.assert_allclose(ls["hist"].numpy(), jls["hist"], rtol=1e-6)


def jit_out(fn, *args):
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


# ---------------------------------------------------------------------------
# pods: the round with the conditional reduction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ref_pods_round(kind, spec, quiet):
    inputs = round_inputs(kind, spec, quiet)
    pol, srv = jcomm.make_policy(spec), jserver.make_server("sgd")
    red = jtopology.PodMesh().reduce_fn()

    def fn(p, ls, g):
        out = jrounds.lag_round(pol, srv, lag_config(jlag, spec), params=p,
                                opt_state=None, lag_state=ls, grads=g,
                                step=jnp.int32(5), reduce_fn=red)
        return out[0], out[2], out[3]

    return jit_out(fn, jax.tree_util.tree_map(jnp.asarray, inputs[2]),
                   ref_lag_state(inputs), inputs[0])


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("quiet", [False, True], ids=["upload", "quiet"])
@pytest.mark.parametrize("spec", ["lag-wk", "lag-ps"])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_pods_round_matches_reference(kind, spec, quiet, mode):
    inputs = round_inputs(kind, spec, quiet)
    lo = layout_for(tt(inputs[2]))
    assert isinstance(lo, MixedLayout) == (kind == "mixed")
    topo = PodMesh(num_units=W)
    ls = port_lag_state(lo, inputs)
    nabla0 = [t.clone() for t in parts_of(ls["nabla"])]
    theta, _, new_ls, m = rounds.lag_round(
        comm.make_policy(spec, fastpath=mode), server.make_server("sgd"),
        lag_config(lag, spec), theta=single(lo, inputs[2]), layout=lo,
        opt_state=None, lag_state=ls, grads=stack(lo, inputs[0]), step=5,
        reduce_fn=topo.reduce_fn())
    check_round(lo, (theta, new_ls, m), ref_pods_round(kind, spec, quiet))
    assert topo.branches == ({"sum": 0, "zero": 1} if quiet
                             else {"sum": 1, "zero": 0})
    if quiet:                 # the zero branch: ∇ unchanged, bit for bit
        assert not m["comm_mask"].any()
        for a, b in zip(parts_of(new_ls["nabla"]), nabla0):
            bitwise(a, b, "nabla")


def test_pods_zero_branch_follows_each_part():
    """A quiet round's zeros have each part's dtype, shape and device."""
    red = PodMesh(num_units=2).reduce_fn()
    lo = layout_for(tt(np_tree("mixed")))
    delta = lo.empty((2,))
    out = red(torch.zeros(2, dtype=torch.bool), delta)
    for o, d in zip(parts_of(out), parts_of(delta)):
        assert o.dtype == d.dtype and o.shape == d.shape[1:]
        assert not o.any()


# ---------------------------------------------------------------------------
# async: the stale views, the round at them, the ring's push
# ---------------------------------------------------------------------------

def ring_tree(kind, theta, tau):
    """θ^k, θ^{k−1}, … : each older iterate θ minus a small step."""
    prev = near(kind, lead(theta, tau), 7, (1e-3,) * tau)
    return jax.tree_util.tree_map(
        lambda t, p: np.concatenate([t[None], p]), theta, prev)


@functools.lru_cache(maxsize=None)
def ref_async_round(kind, spec, tau):
    inputs = round_inputs(kind, spec)
    pol, srv = jcomm.make_policy(spec), jserver.make_server("sgd")
    topo = jtopology.AsyncShards(staleness=tau)
    ls = dict(ref_lag_state(inputs),
              theta_ring=ring_tree(kind, inputs[2], tau))

    def fn(p, ls, g):
        views = topo.worker_views(p, ls, W)
        new_p, _, new_ls, m = jrounds.lag_round(
            pol, srv, lag_config(jlag, spec), params=p, opt_state=None,
            lag_state=ls, grads=g, step=jnp.int32(5), theta_view=views)
        return new_p, dict(new_ls, **topo.advance_views(new_ls, new_p)), m

    return jit_out(fn, jax.tree_util.tree_map(jnp.asarray, inputs[2]), ls,
                   inputs[0])


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("tau", [1, 2], ids=["gather", "ring-is-view"])
@pytest.mark.parametrize("spec", ["lag-wk", "lag-ps"])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_async_round_matches_reference(kind, spec, tau, mode):
    inputs = round_inputs(kind, spec)
    lo = layout_for(tt(inputs[2]))
    topo = AsyncShards(staleness=tau)
    theta = single(lo, inputs[2])
    ls = port_lag_state(lo, inputs)
    ls["theta_ring"] = stack_n(lo, ring_tree(kind, inputs[2], tau), tau + 1)
    views = topo.worker_views(theta, ls, W)
    # W = τ+1 with the ramp 0..τ: the ring itself is the view, no copy
    assert (views is ls["theta_ring"]) == (tau == 2)
    theta, _, new_ls, m = rounds.lag_round(
        comm.make_policy(spec, fastpath=mode), server.make_server("sgd"),
        lag_config(lag, spec), theta=theta, layout=lo, opt_state=None,
        lag_state=ls, grads=stack(lo, inputs[0]), step=5, theta_view=views)
    del views
    new_ls.update(topo.advance_views(new_ls, theta))
    jtheta, jls, jm = ref_async_round(kind, spec, tau)
    check_round(lo, (theta, new_ls, m), (jtheta, jls, jm))
    ring = rows_of(lo, new_ls["theta_ring"], tau + 1)
    want = ref_leaves(jls["theta_ring"])
    check_theta([r[0] for r in ring], [w[0] for w in want], "ring[0]")
    for i, (g, w) in enumerate(zip(ring, want)):       # the older slots
        bitwise(g[1:], w[1:], f"ring[1:][{i}]")


# ---------------------------------------------------------------------------
# fleet: gather → round → scatter into the float32 compact rows
# ---------------------------------------------------------------------------

def population_rows(kind, inputs, key, cohort):
    """N clients' mirror values of ``key`` (the cohort's the round
    inputs', the others' random), as a stacked (N, …) tree."""
    others = np_tree(kind, (N_POP,), 11 + len(key))
    st = inputs[1][key]

    def put(o, s):
        o = o.copy()
        o[list(cohort)] = s
        return o

    return jax.tree_util.tree_map(put, others, st)


def fleet_setup(kind, spec, churn):
    """(inputs, the compact rows of each mirror (float32 numpy), cohort,
    alive, active)."""
    inputs = round_inputs(kind, spec)
    jlo = jfleet.Population.for_template(
        jax.tree_util.tree_map(jnp.asarray, inputs[2]),
        jcomm.make_policy(spec).state_keys, N_POP).layout
    rows = {k: np.asarray(jlo.pack_stacked(
        population_rows(kind, inputs, k, COHORT))) for k in inputs[1]}
    alive = np.ones(N_POP, bool)
    if churn:
        alive[COHORT[1]] = False          # drops out mid-round
    return inputs, rows, np.asarray(COHORT, np.int32), alive, \
        alive[list(COHORT)]


def bookkeeping(n):
    return (np.arange(n, dtype=np.int32),
            np.linspace(1.0, 2.0, n).astype(F32))


@functools.lru_cache(maxsize=None)
def ref_fleet_round(kind, spec, churn):
    inputs, rows, cohort, alive, active = fleet_setup(kind, spec, churn)
    pol, srv = jcomm.make_policy(spec), jserver.make_server("sgd")
    params = jax.tree_util.tree_map(jnp.asarray, inputs[2])
    pop = jfleet.Population.for_template(params, pol.state_keys, N_POP)
    topo = jfleet.FleetTopology(N_POP, W, churn=churn)
    age, innov = bookkeeping(N_POP)
    ls = {MIRROR_PREFIX + k: v for k, v in rows.items()}
    _, _, nabla, hist = inputs[1:]
    ls.update(nabla=nabla, hist=hist, comm_total=np.int32(0),
              comm_per_worker=np.zeros(N_POP, np.int32),
              fleet_alive=np.ones(N_POP, bool), fleet_age=age,
              fleet_innov=innov)

    def fn(p, ls, g):
        cpst = pop.gather_state(ls, cohort, like=p)
        new_p, _, new_ls, m = jfleet_rounds.fleet_round(
            pol, srv, lag_config(jlag, spec, N_POP), topology=topo,
            population=pop, params=p, opt_state=None, lag_state=ls,
            alive=alive, cohort=cohort, active=active, cohort_pst=cpst,
            grads=g, step=jnp.int32(5), L_cohort=jnp.full((W,), 10.0))
        return new_p, new_ls, m

    return jit_out(fn, params, ls, inputs[0])


def grad_hat_bound(inputs, comm_mask, want):
    """½ ulp(g − ĝ) + ½ ulp(ĝ') at bfloat16 on the uploaders' compact rows
    (queue 3 (a)), 0 elsewhere."""
    jlo = jfleet.Population.for_template(
        jax.tree_util.tree_map(jnp.asarray, inputs[2]), ("grad_hat",),
        N_POP).layout
    packed = lambda t: torch.from_numpy(np.array(
        jlo.pack_stacked(t))).double()
    pay = packed(inputs[0]) - packed(inputs[1]["grad_hat"])
    bound = torch.zeros(want.shape, dtype=torch.float64)
    for j, c in enumerate(COHORT):
        if comm_mask[j]:
            bound[c] = (ulp(pay[j], 8) + ulp(want[c], 8)) / 2
    return bound


@pytest.mark.parametrize("mode", ["on", "auto"])
@pytest.mark.parametrize("churn", [0.0, 0.25], ids=["all", "dropout"])
@pytest.mark.parametrize("spec", ["lag-wk", "lag-ps"])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_fleet_round_matches_reference(kind, spec, churn, mode):
    inputs, rows, cohort, alive, active = fleet_setup(kind, spec, churn)
    lo = layout_for(tt(inputs[2]))
    pol = comm.make_policy(spec, fastpath=mode)
    pop = Population.for_policy(lo, pol, N_POP)
    age, innov = bookkeeping(N_POP)
    ls = {MIRROR_PREFIX + k: torch.tensor(v) for k, v in rows.items()}
    ls.update(nabla=single(lo, inputs[3]),
              hist=torch.from_numpy(inputs[4].copy()),
              comm_total=torch.zeros((), dtype=torch.int32),
              comm_per_worker=torch.zeros(N_POP, dtype=torch.int32),
              fleet_alive=torch.ones(N_POP, dtype=torch.bool),
              fleet_age=torch.from_numpy(age),
              fleet_innov=torch.from_numpy(innov))
    for v in rows.values():
        assert v.dtype == np.float32
    cohort_t = torch.from_numpy(cohort).long()
    cpst = pop.gather_state(ls, cohort_t)
    for key, st in inputs[1].items():      # the gather is exact
        for a, b in zip(parts_of(cpst[key]), parts_of(stack(lo, st))):
            bitwise(a, b, "gathered " + key)
    theta, _, new_ls, m = fleet_round(
        pol, server.make_server("sgd"), lag_config(lag, spec, N_POP),
        topology=FleetTopology(N_POP, W, churn=churn), population=pop,
        theta=single(lo, inputs[2]), layout=lo, opt_state=None,
        lag_state=ls, alive=torch.from_numpy(alive), cohort=cohort_t,
        active=torch.from_numpy(active), cohort_pst=cpst,
        grads=stack(lo, inputs[0]), step=5, L_cohort=torch.full((W,), 10.0))
    jtheta, jls, jm = ref_fleet_round(kind, spec, churn)
    for k in ("cohort_comm", "comm_mask", "cohort_active"):
        np.testing.assert_array_equal(m[k].numpy(), jm[k])
    for k in rows:
        mir = new_ls[MIRROR_PREFIX + k]
        assert mir.dtype == torch.float32
        want = torch.from_numpy(np.array(jls[MIRROR_PREFIX + k]))
        if k == "grad_hat":
            # queue 3 (a): XLA fuses the uploaders' ĝ + (g − ĝ) into the
            # float32 scatter without its bfloat16 roundings; the port's row
            # is its bfloat16 ĝ widened.  Every other row bitwise.
            within(mir, want, grad_hat_bound(inputs, m["cohort_comm"],
                                             want), "rows grad_hat")
            up = sorted(COHORT[j] for j in range(W)
                        if m["cohort_comm"][j])
            keep = [i for i in range(N_POP) if i not in up]
            bitwise(mir[keep], want[keep], "rows grad_hat")
        else:
            bitwise(mir, want, "rows " + k)
    if churn:        # the dropout's rows are the old ones, bit for bit
        for k, v in rows.items():
            bitwise(new_ls[MIRROR_PREFIX + k][COHORT[1]],
                    torch.tensor(v[COHORT[1]]), "dropout " + k)
    for i, (g, w) in enumerate(zip(leaves(lo, new_ls["nabla"]),
                                   ref_leaves(jls["nabla"]))):
        bitwise(g, w, f"nabla[{i}]")
    check_theta(leaves(lo, theta), ref_leaves(jtheta), "theta")
    for k in ("fleet_age", "comm_per_worker", "comm_total"):
        np.testing.assert_array_equal(new_ls[k].numpy(), jls[k])
    np.testing.assert_allclose(new_ls["fleet_innov"].numpy(),
                               jls["fleet_innov"], rtol=INNOV_RTOL)


def test_population_rows_interleave_the_parts_by_leaf():
    """A mixed tree's compact row is the reference's ``FlatLayout.
    for_tree`` of the whole tree: every leaf in tree order, the bfloat16
    and float32 leaves interleaved; gather and scatter round-trip it."""
    tree = np_tree("mixed", (N_POP,), 5)
    jrows = np.asarray(jfleet.Population.for_template(
        jax.tree_util.tree_map(jnp.asarray, np_tree("mixed")), ("grad_hat",),
        N_POP).layout.pack_stacked(tree))
    lo = layout_for(tt(np_tree("mixed")))
    pop = Population.for_template(lo, ("grad_hat",), N_POP)
    assert lo.packed_cols == jrows.shape[1]
    st = pop.init_state("cpu")
    assert st[MIRROR_PREFIX + "grad_hat"].dtype == torch.float32
    everyone = torch.arange(N_POP)
    pop.scatter_state(st, everyone, {"grad_hat": stack_n(lo, tree, N_POP)})
    bitwise(st[MIRROR_PREFIX + "grad_hat"], torch.from_numpy(jrows), "rows")
    back = pop.gather_state(st, everyone)["grad_hat"]
    for a, b in zip(parts_of(back), parts_of(stack_n(lo, tree, N_POP))):
        bitwise(a, b, "gather")


# ---------------------------------------------------------------------------
# The identities: pods:2, async:2@0, fleet:2@2 ≡ shards, bitwise
# ---------------------------------------------------------------------------

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
BATCH, SEQ, STEPS = 4, 16, 3
#: (topology, lr, one fixed batch): pods on the quiet setting of
#: test_torch_bf16_topologies (rounds 1 and 2 skip the reduction)
IDENTITIES = [("pods:2", 0.005, True), ("async:2@0", 0.3, False),
              ("fleet:2@2", 0.3, False)]
ROUTES = {"plane": {"fastpath": "on"}, "plain": {},
          "legacy": {"use_pallas_comm": True}}


def ident_run(arch, spec, algo, lr, fixed, route):
    cfg = get_config(arch).reduced(**BF16)
    tcfg = TrainerConfig(algo=algo, num_workers=2, lr=lr, **ROUTES[route])
    topo = make_topology(spec)
    if spec.startswith("fleet"):
        st = fleet.init_fleet_state(cfg, tcfg, topo, device="cpu", seed=3)
        step = fleet.make_fleet_step(cfg, tcfg, topo)
    else:
        st = init_state(cfg, tcfg, device="cpu", seed=3, topology=topo)
        step = make_train_step(cfg, tcfg, topology=topo)
    stream = TokenStream(cfg.vocab_size)
    batch = make_heterogeneous_inputs(cfg, stream, 0, 2, BATCH, SEQ,
                                      device="cpu") if fixed else None
    out = []
    for k in range(STEPS):
        st, m = step(st, batch if fixed else make_inputs(
            cfg, stream, k, BATCH, SEQ, device="cpu"))
        out.append((float(m["loss"]), m["comm_mask"].tolist()))
    return out, st, topo


def check_identities(arch, algo, route):
    shards = {}
    for spec, lr, fixed in IDENTITIES:
        if (lr, fixed) not in shards:
            shards[lr, fixed] = ident_run(arch, "shards", algo, lr, fixed,
                                          route)[:2]
        s_out, s_st = shards[lr, fixed]
        out, st, topo = ident_run(arch, spec, algo, lr, fixed, route)
        assert out == s_out, (spec, out, s_out)
        for a, b in zip(parts_of(st["theta"]), parts_of(s_st["theta"])):
            bitwise(a, b, spec + " theta")
        for a, b in zip(parts_of(st["lag"]["nabla"]),
                        parts_of(s_st["lag"]["nabla"])):
            bitwise(a, b, spec + " nabla")
        policy = TrainerConfig(algo=algo).comm_policy()
        if spec.startswith("fleet"):
            # the compact rows gathered back are the shards' mirrors
            pop = Population.for_policy(param_layout(
                get_config(arch).reduced(**BF16)), policy, 2)
            got = pop.gather_state(st["lag"], torch.arange(2))
        else:
            got = st["lag"]
        for k in policy.state_keys:
            for a, b in zip(parts_of(got[k]), parts_of(s_st["lag"][k])):
                bitwise(a, b, f"{spec} {k}")
        if spec.startswith("pods"):
            skipped = int(st["lag"]["rounds_skipped"])
            assert topo.branches["zero"] == skipped
            assert skipped == 2 or algo != "lag-wk"


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("algo", ["lag-wk", "lag-ps", "laq@4"])
def test_topologies_are_bitwise_shards_at_bf16(algo, route):
    check_identities("llama3.2-1b", algo, route)


@pytest.mark.parametrize("algo", ["lag-wk", "lag-ps", "laq@4"])
def test_topologies_are_bitwise_shards_on_a_mixed_tree(algo):
    check_identities("mamba2-370m", algo, "plane")
