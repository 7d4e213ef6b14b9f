"""The ranks of ``tests/test_torch_devrun.py``: functions that
``repro_torch.devrun.launch`` runs in spawned processes, one a rank of a
gloo group on the CPU.  The module imports no JAX (a spawned rank imports
it to find its function), and both sides of a parity check run the same
``run_case``: the device plane at ``devices:D`` here, the in-process
trainer at ``shards:D`` in the test (``topology=None``).

A case is ``(algo, steps, extras)``; extras: ``quiet`` (one more round with
the history raised by 1e9, so no worker fires) and ``ckpt`` (save at step
2, then restore a fresh state from that file and run round 3 again).
"""
import contextlib
import io
import os

from repro_torch import devrun
from repro_torch.comm import SampledSchedule, ScheduledPolicy
from repro_torch.configs import get_config
from repro_torch.data import TokenStream, make_inputs
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.engine.topology import make_topology
from repro_torch.weights import params_from_reference

BATCH, SEQ, LR, XI = 4, 32, 0.3, 0.1
QUIET = 1e9
LAUNCH_ARGV = ["--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
               "--device", "cpu"]
EXPERIMENT = dict(model="llama3.2-1b", algo="laq@4", steps=2, batch=4, seq=16,
                  lr=LR, device="cpu")


def config():
    return get_config("llama3.2-1b").reduced()


def policy_for(tcfg, draws):
    """``tcfg``'s policy; a sampled schedule draws ``draws[k]`` (the
    reference's workers) at round k."""
    pol = tcfg.comm_policy()
    if not pol.needs_rng:
        return pol
    return ScheduledPolicy(pol.inner, SampledSchedule(draw=draws.__getitem__))


def run_case(algo, steps, W, ref_params, draws=None, quiet=False,
             ckpt_dir=None, devices=True):
    """``steps`` rounds of ``algo`` at ``devices:W`` (this rank's state) or
    ``shards:W`` → masks, losses, θ, the mirror state (this rank's row, or
    all W), the counters and each round's collective records."""
    cfg = config()
    tcfg = TrainerConfig(algo=algo, num_workers=W, lr=LR, xi=XI,
                         fastpath="on")
    policy = policy_for(tcfg, draws)
    params = params_from_reference(ref_params, cfg, device="cpu")

    def fresh():
        if devices:
            topo = make_topology(f"devices:{W}")
            return (devrun.init_device_state(cfg, tcfg, device="cpu",
                                             params=params, policy=policy,
                                             topology=topo),
                    devrun.make_device_step(cfg, tcfg, policy=policy,
                                            topology=topo))
        return (init_state(cfg, tcfg, device="cpu", params=params,
                           policy=policy),
                make_train_step(cfg, tcfg, policy=policy))

    def batch(k):
        return make_inputs(cfg, TokenStream(cfg.vocab_size), k, BATCH, SEQ,
                           device="cpu")

    def snapshot(state):
        return {"theta": state["theta"].numpy().copy(),
                **{k: state["lag"][k].numpy().copy()
                   for k in policy.state_keys},
                "nabla": state["lag"]["nabla"].numpy().copy(),
                "comm_per_worker":
                    state["lag"]["comm_per_worker"].numpy().copy(),
                "comm_total": int(state["lag"]["comm_total"])}

    state, step = fresh()
    out = {"masks": [], "losses": [], "records": []}
    for k in range(steps):
        state, m = step(state, batch(k))
        out["masks"].append(m["comm_mask"].tolist())
        out["losses"].append(float(m["loss"]))
        out["records"].append(m.get("records"))
        if ckpt_dir is not None and k == 1:
            if devices:
                devrun.save_checkpoint(ckpt_dir, 2, state, policy)
            else:
                from repro_torch.checkpoint import save
                save(ckpt_dir, 2, state)
    out["final"] = snapshot(state)
    if ckpt_dir is not None and devices:
        again, step2 = fresh()
        again, at = devrun.restore_checkpoint(ckpt_dir, again, policy)
        for k in range(at, steps):
            again, _ = step2(again, batch(k))
        out["resumed"] = snapshot(again)
    if quiet:
        state["lag"]["hist"] = state["lag"]["hist"] + QUIET
        state, m = step(state, batch(steps))
        out["quiet"] = {"mask": m["comm_mask"].tolist(),
                        "loss": float(m["loss"]),
                        "records": m.get("records"),
                        **snapshot(state)}
    return out


def world(rank, W, cases, ref_params, draws, ckpt_dir, refusals=False):
    """Every case of a world of W ranks, plus (``refusals``) the launcher
    on ``devices:W`` (rank 0's printed lines) and the refusals a group
    sees."""
    got = {}
    for algo, steps, extra in cases:
        got[algo] = run_case(algo, steps, W, ref_params, draws=draws,
                             ckpt_dir=ckpt_dir if extra == "ckpt" else None,
                             quiet=extra == "quiet")
    if refusals:
        from repro_torch.launch import train
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(LAUNCH_ARGV + ["--topology", f"devices:{W}",
                                      "--dist-backend", "gloo"])
        got["launcher"] = buf.getvalue().splitlines()
        from repro_torch.engine import Experiment
        r = Experiment(topology=f"devices:{W}", **EXPERIMENT).run()
        got["experiment"] = (r.losses, r.comm_mask, r.bytes_per_upload,
                             r.topology)
        cfg = config()
        for name, c, spec in (
                ("world", cfg, f"devices:{W + 2}"),
                ("bf16", cfg.replace(dtype="bfloat16",
                                     param_dtype="bfloat16"),
                 f"devices:{W}")):
            try:
                devrun.init_device_state(
                    c, TrainerConfig(algo="lag-wk", num_workers=W),
                    device="cpu", topology=make_topology(spec))
                got[name] = None
            except (ValueError, NotImplementedError) as e:
                got[name] = f"{type(e).__name__}: {e}"
    got["pid"] = os.getpid()
    return got
