"""LASG-WK, the schedules and the server steps: the port against the LIVE
JAX reference (``repro.comm``, ``repro.engine.server``,
``repro.dist.lag_trainer``) on the same numpy inputs.

* each server's ``apply`` (sgd, momentum@0.9, adam, prox-l1@1e-3) over 3
  steps on the flat buffers the trainer hands it, bit for bit against the
  reference's on the tree; prox-l1's composite loss;
* 3 trainer rounds of lag-adam, and of lag-wk with the momentum and prox-l1
  servers, on the reduced model (masks equal, losses within rtol 1e-4,
  parameters within rtol 1e-4 / atol 1e-6; for Adam outside a bounded
  share of coordinates, see ``ADAM_FLIP_SHARE``);
* the spec grammars of ``make_policy`` / ``make_server`` and their error
  messages, the sampled schedule's default draw, LASG-WK without
  ``grad_at_hat``, and every new spec through the CPU launcher.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.configs import get_config as jget_config
from repro.core import lag as jlag
from repro.data import TokenStream as JTokenStream
from repro.data import make_inputs as jmake_inputs
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import make_train_step as jmake_train_step
from repro.dist.lag_trainer import ALGOS as JALGOS
from repro.engine import server as jserver

from repro_torch import comm
from repro_torch.configs import get_config
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist.lag_trainer import (ALGOS, TrainerConfig, init_state,
                                          make_train_step, params_of)
from repro_torch.engine import rounds
from repro_torch.engine import server
from repro_torch.fastpath.layout import FlatLayout
from repro_torch.launch import train as launch_train
from repro_torch.weights import params_from_reference

SERVER_SPECS = ["sgd", "momentum@0.9", "adam", "prox-l1@1e-3"]
W, BATCH, SEQ, STEPS = 2, 4, 32, 3
# Adam in the trainer (lag-adam, lr 1e-3, 3 rounds, reduced model): Adam
# moves a coordinate by about lr·sign(mean gradient) whatever the
# gradient's size, so where the two packages' aggregates sit near zero, a
# few-ulp difference between their matmuls changes the step by up to 2·lr
# (a flipped sign).  The server step itself is bitwise
# (test_server_apply_matches_reference).  Measured on this setup: 78 of
# 1,312,000 parameters off rtol 1e-4 / atol 1e-6, by at most 2.4e-4;
# bounded at 2e-4 of the parameters and 2·lr.
ADAM_LR = 1e-3
ADAM_FLIP_SHARE, ADAM_MAX_DTHETA = 2e-4, 2 * ADAM_LR


def np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"w": mk(3, 40), "b": mk(7), "blk": [mk(1030), mk(1)]}


def to_t(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


# ---------------------------------------------------------------------------
# Servers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SERVER_SPECS)
def test_server_apply_matches_reference(spec):
    """3 steps (state carried on) with a fresh aggregate each; the port
    steps the flat buffers, as the trainer does.  Bitwise: the reference
    runs op by op here (no jit, so no fused multiply-adds), and the port
    keeps its order of operations, float32 scalars and IEEE sqrt."""
    cfg = lag.LAGConfig(num_workers=3, alpha=0.1)
    jcfg = jlag.LAGConfig(num_workers=3, alpha=0.1)
    params = np_tree(0)
    # aggregates of mixed sizes, some coordinates near zero
    nablas = [jax.tree_util.tree_map(
        lambda x, k=k: x * np.float32(10.0 ** (k - 1)), np_tree(10 + k))
        for k in range(3)]
    jsrv, srv = jserver.make_server(spec), server.make_server(spec)
    jp, jopt = params, jsrv.init(params)
    lo = FlatLayout.for_tree(to_t(params))
    theta = lo.flatten(to_t(params))
    opt = srv.init(theta)
    assert (opt is None) == (jopt is None)
    for k, nab in enumerate(nablas):
        jp, jopt = jsrv.apply(jp, jopt, nab, jnp.asarray(k, jnp.int32), jcfg)
        theta, opt = srv.apply(theta, opt, lo.flatten(to_t(nab)), k, cfg)
        for a, b in zip(tree_leaves(lo.unflatten(theta)),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the padding of the flat buffer stays zero under every step
    assert float(theta.view(-1)[lo.sizes[0]:1024].abs().sum()) == 0.0


def test_server_state_is_flat_and_updated_in_place():
    lo = FlatLayout.for_tree(to_t(np_tree(0)))
    theta = lo.flatten(to_t(np_tree(0)))
    cfg = lag.LAGConfig(num_workers=2, alpha=0.1)
    for spec, keys in (("momentum@0.9", None), ("adam", ("mu", "nu"))):
        srv = server.make_server(spec)
        opt = srv.init(theta)
        bufs = [opt] if keys is None else [opt[k] for k in keys]
        assert all(b.shape == theta.shape for b in bufs)
        ptrs = [b.data_ptr() for b in bufs]
        _, new = srv.apply(theta, opt, lo.flatten(to_t(np_tree(3))), 0, cfg)
        new_bufs = [new] if keys is None else [new[k] for k in keys]
        assert [b.data_ptr() for b in new_bufs] == ptrs


def test_optimizers_match_reference():
    """The rest of ``optim``: the cosine schedule, global-norm clipping and
    AdamW (3 steps, bitwise against the reference run op by op)."""
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers as opt
    jsched, sched = (m.cosine_schedule(0.5, 3, 10) for m in (jopt, opt))
    for k in (0, 1, 3, 6, 10, 12):
        assert float(sched(k)) == float(jsched(jnp.asarray(k, jnp.int32)))
    grads = np_tree(5, scale=3.0)
    for max_norm in (1.0, 1e3):
        for a, b in zip(tree_leaves(opt.clip_by_global_norm(to_t(grads),
                                                            max_norm)),
                        jax.tree_util.tree_leaves(
                            jopt.clip_by_global_norm(grads, max_norm))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    jo, o = jopt.adamw(0.01), opt.adamw(0.01)
    jp, p = np_tree(0), to_t(np_tree(0))
    jst, st = jo.init(jp), o.init(p)
    for k in range(3):
        g = np_tree(20 + k)
        jp, jst = jo.update(g, jst, jp, jnp.asarray(k, jnp.int32))
        p, st = o.update(to_t(g), st, p, k)
        for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_prox_l1_composite_loss_matches_reference():
    params = np_tree(4)
    jl = jserver.make_server("prox-l1@1e-3").composite_loss(
        jnp.float32(2.5), params)
    pl = server.make_server("prox-l1@1e-3").composite_loss(
        torch.tensor(2.5), to_t(params))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    assert float(pl) > 2.5


# ---------------------------------------------------------------------------
# The trainer with the server steps
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


@pytest.mark.parametrize("algo,server_spec,lr", [
    ("lag-adam", None, ADAM_LR), ("lag-wk", "momentum@0.9", 0.3),
    ("lag-wk", "prox-l1@1e-3", 0.3)])
def test_trainer_server_matches_live_reference(cfgs, ref_params, algo,
                                               server_spec, lr):
    jcfg, cfg = cfgs
    kw = dict(algo=algo, num_workers=W, lr=lr, server=server_spec,
              fastpath="on")
    jt = JTrainerConfig(**kw)
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jt)
    jstep = jax.jit(jmake_train_step(jcfg, jt))
    tcfg = TrainerConfig(**kw)
    state = init_state(cfg, tcfg, device="cpu",
                       params=params_from_reference(
                           ref_params, cfg, device="cpu"))
    assert ("opt" in state) == ("opt" in jstate)
    step = make_train_step(cfg, tcfg)
    jstream, stream = JTokenStream(jcfg.vocab_size), TokenStream(
        cfg.vocab_size)
    for k in range(STEPS):
        jstate, jm = jstep(jstate, jmake_inputs(jcfg, jstream, k, BATCH,
                                                SEQ))
        state, m = step(state, make_inputs(cfg, stream, k, BATCH, SEQ,
                                           device="cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_array_equal(m["comm_mask"].numpy(),
                                      np.asarray(jm["comm_mask"]))
    flips, n = 0, 0
    for a, b in zip(tree_leaves(params_of(state, cfg)),
                    jax.tree_util.tree_leaves(jstate["params"])):
        a, b = a.numpy(), np.asarray(b)
        if algo != "lag-adam":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
            continue
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
        assert np.all(np.abs(a - b) <= ADAM_MAX_DTHETA)
        flips, n = flips + int(off.sum()), n + a.size
    assert flips <= ADAM_FLIP_SHARE * n


# ---------------------------------------------------------------------------
# Grammar, the sampler, LASG-WK's contract, the launcher
# ---------------------------------------------------------------------------

def test_make_policy_spec_strings():
    assert isinstance(comm.make_policy("lasg-wk"), comm.LASGWKPolicy)
    assert isinstance(comm.make_policy("lag-wk"), comm.LAGWKPolicy)
    p = comm.make_policy("laq@8")
    assert isinstance(p, comm.LAQPolicy) and p.bits == 8
    assert comm.make_policy("laq@3", bits=6).bits == 3
    assert comm.make_policy("laq", bits=6).bits == 6
    assert isinstance(comm.make_policy("adam"), comm.GDPolicy)
    assert isinstance(comm.make_policy("lag-adam"), comm.LAGWKPolicy)
    assert set(comm.POLICIES) == set(jcomm.POLICIES)


def test_make_policy_scheduled_specs():
    p = comm.make_policy("cyc-iag")
    assert isinstance(p, comm.ScheduledPolicy)
    assert isinstance(p.inner, comm.GDPolicy)
    assert isinstance(p.schedule, comm.CyclicSchedule)
    assert not p.needs_rng
    p = comm.make_policy("num-iag", probs=[0.25, 0.75])
    assert isinstance(p.schedule, comm.SampledSchedule) and p.needs_rng
    p = comm.make_policy("cyc-laq@8")
    assert isinstance(p.inner, comm.LAQPolicy) and p.inner.bits == 8
    assert p.name == "cyc-laq"
    assert p.state_keys == p.inner.state_keys
    p = comm.make_policy("num-lasg-wk")
    assert p.needs_grad_at_hat and p.needs_theta_hat and p.needs_rng
    # the schedule wraps the inner policy's plane (or its absence)
    assert comm.make_policy("cyc-laq@4", fastpath="on").fastpath.mode == "on"
    assert comm.make_policy("cyc-laq@4", use_pallas=True).fastpath is None


@pytest.mark.parametrize("spec,match", [
    ("sgd", "unknown comm policy 'sgd'"), ("sgd", "known algos"),
    ("rand-iag", "cyc-iag"), ("iag", "cyc-iag"), ("", "non-empty string"),
    ("laq@nope", "not an integer bit width"),
    ("laq@0", r"bits must be in \[2, 16\]"),
    ("lag-wk@4", "no spec parameter")])
def test_make_policy_errors_match_reference(spec, match):
    for make in (comm.make_policy, jcomm.make_policy):
        with pytest.raises(ValueError, match=match):
            make(spec)


def test_make_server_specs():
    assert isinstance(server.make_server("sgd"), server.SGDServer)
    assert server.make_server("momentum@0.8").momentum == 0.8
    assert server.make_server("prox-l1@5.0").l1 == 5.0
    assert isinstance(server.make_server("adam"), server.AdamServer)
    assert server.make_server("adam", b1=0.8).b1 == 0.8
    assert set(server.SERVERS) == set(jserver.SERVERS)


@pytest.mark.parametrize("spec,match", [
    ("adagrad", "unknown server optimizer"), ("momentum@fast", "not a float"),
    ("sgd@0.1", "takes no '@' parameter"), ("prox-l1@-1", "must be positive"),
    ("momentum@1.5", r"momentum must be in \(0, 1\)"),
    ("", "non-empty string")])
def test_make_server_errors_match_reference(spec, match):
    for make in (server.make_server, jserver.make_server):
        with pytest.raises(ValueError, match=match):
            make(spec)


def test_trainer_config_takes_every_reference_algo():
    assert ALGOS == JALGOS
    for algo in JALGOS:
        TrainerConfig(algo=algo, num_workers=W)
    for spec in ("cyc-iag", "num-iag", "cyc-laq@4", "num-lag-wk"):
        TrainerConfig(algo=spec, num_workers=W)
    with pytest.raises(ValueError, match="unknown comm policy"):
        TrainerConfig(algo="nope")
    with pytest.raises(ValueError, match="unknown server optimizer"):
        TrainerConfig(server="adagrad")
    with pytest.raises(ValueError, match="conflicting comm-plane configs"):
        TrainerConfig(algo="lasg-wk", use_pallas_comm=True, fastpath="on")


@pytest.mark.parametrize("kw,want", [
    ({}, server.SGDServer), ({"momentum": 0.9}, server.MomentumServer),
    ({"algo": "adam"}, server.AdamServer),
    ({"algo": "lag-adam", "momentum": 0.9}, server.AdamServer),
    ({"algo": "lag-adam", "server": "prox-l1@1e-4"}, server.ProxL1Server)])
def test_server_optimizer_order_matches_reference(kw, want):
    got = TrainerConfig(**kw).server_optimizer()
    ref = JTrainerConfig(**kw).server_optimizer()
    assert isinstance(got, want) and type(ref).__name__ == want.__name__
    assert TrainerConfig(**kw).uses_adam == JTrainerConfig(**kw).uses_adam


def test_sampled_schedule_default_draw():
    """Deterministic in (seed, step), every worker reachable, a worker of
    probability 0 never drawn."""
    s = comm.SampledSchedule()
    draws = [s.draw(k, 4, seed=7) for k in range(200)]
    assert draws == [s.draw(k, 4, seed=7) for k in range(200)]
    assert draws != [s.draw(k, 4, seed=8) for k in range(200)]
    assert set(draws) == {0, 1, 2, 3}
    p = comm.SampledSchedule(probs=[0.0, 0.5, 0.0, 0.5])
    assert {p.draw(k, 4) for k in range(200)} == {1, 3}
    with pytest.raises(ValueError, match="probs has shape"):
        p.draw(0, 3)
    assert comm.SampledSchedule(draw=lambda k: k % 3).draw(7, 3) == 1


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_lasg_wk_without_grad_at_hat_raises(mode):
    tree = {"w": torch.zeros(300)}
    lo = FlatLayout.for_tree(tree)
    pol = comm.make_policy("lasg-wk", fastpath=mode)
    cfg = lag.LAGConfig(num_workers=2, alpha=0.1, D=4, xi=0.25)
    st = {"grad_hat": lo.empty((2,)), "theta_hat": lo.empty((2,)),
          "hist": lag.hist_init(4, "cpu")}
    with pytest.raises(ValueError, match="LASG-WK requires grad_at_hat"):
        rounds.policy_rounds(pol, cfg, lo.empty(), lo.empty((2,)), st, lo)


@pytest.mark.parametrize("argv", [
    ["--algo", "lasg-wk"], ["--algo", "cyc-iag"], ["--algo", "num-iag"],
    ["--algo", "cyc-laq@4", "--fastpath", "on"], ["--algo", "lag-adam"],
    ["--algo", "lag-wk", "--server", "momentum@0.9"],
    ["--algo", "lag-wk", "--server", "prox-l1@1e-3"]])
def test_cli_runs_every_new_spec_on_the_cpu(argv, capsys):
    state = launch_train.main(["--reduced", "--device", "cpu", "--steps",
                               "3", "--workers", "2", "--batch", "2",
                               "--seq", "8"] + argv)
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "done: 3 rounds" in out
    assert bool(torch.isfinite(state["theta"]).all())
    if argv[1].startswith(("cyc-", "num-")):
        assert int(state["lag"]["comm_total"]) == 3   # one uploader a round
    if argv[1] == "num-iag":
        assert "sampled uploaders of rounds 0-2" in out
