"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --algo lag-wk --workers 2 --batch 4 --seq 256 --steps 4 \\
      --hetero 0.8 --cluster hetero:2@10ms/1Gbps

Runs on the GPU (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` asks for the CPU.  Prints the loss and the LAG
communication counters of every round, and the time per round (the host
clock around work that ends in a device synchronise).

``--topology`` selects the placement (``repro_torch.engine.topology``
specs): ``shards`` (default), ``pods:2`` (quiet rounds skip the
reduction), ``async:4@2`` (bounded staleness), or the sampled-cohort fleet
``fleet:100000@64`` (``repro_torch.fleet``; ``--fleet-churn`` and
``--fleet-selection`` dial dropout and lazy client selection).
``--hetero`` dials the worker shards' data heterogeneity
(``repro_torch.netsim.hetero``); ``--cluster`` prices the run's uploads
on a simulated network (``repro_torch.netsim.cluster``: per worker, per
client for a fleet) and prints the simulated wall-clock against GD's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.data import (TokenStream, make_heterogeneous_inputs,
                              make_inputs)
from repro_torch.device import resolve_device
from repro_torch.dist.lag_trainer import (ALGOS, TrainerConfig, init_state,
                                          make_train_step, params_of,
                                          phase_ms)


def build_argparser():
    p = argparse.ArgumentParser(description="LAG distributed trainer "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--algo", default="lag-wk",
                   help=f"trainer algo ({', '.join(ALGOS)}) or any comm "
                        f"policy spec [cyc-|num-]<algo>[@<bits>]: "
                        f"'laq@8', 'cyc-iag', 'num-iag', 'cyc-laq@4', "
                        f"'num-lag-wk'")
    p.add_argument("--server", default=None,
                   help="server-optimizer spec overriding the algo's "
                        "(sgd, adam, 'momentum@0.9', 'prox-l1@1e-4')")
    p.add_argument("--topology", default=None,
                   help="topology spec ('shards', 'pods:2', 'async:4@2', "
                        "'fleet:100000@64'); default: flat batch shards.  "
                        "fleet:N@k samples a k-client cohort per round from "
                        "N clients (W is then k)")
    p.add_argument("--fleet-churn", type=float, default=0.0,
                   help="fleet only: per-round client leave probability "
                        "(clients re-join with stale state)")
    p.add_argument("--fleet-selection", default="uniform",
                   choices=["uniform", "innovation"],
                   help="fleet only: cohort selection rule; 'innovation' is "
                        "the lazy (trigger-ranked) server-side selection")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.3)
    p.add_argument("--xi", type=float, default=0.1)
    p.add_argument("--D", type=int, default=10)
    p.add_argument("--hetero", type=float, default=None,
                   help="worker-shard heterogeneity dial h in [0, 1] (the "
                        "token-noise ramp); default: one homogeneous "
                        "stream")
    p.add_argument("--cluster", default=None,
                   help="price the run on a simulated network, e.g. "
                        "'hetero:2@10ms/1Gbps' (its worker count must be "
                        "W, the population for a fleet)")
    p.add_argument("--fastpath", default="auto", choices=["auto", "on"],
                   help="batched flat-buffer comm plane: auto = on for CUDA "
                        "tensors (the per-leaf oracle on the CPU), on = "
                        "forced (plain kernel versions on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    p.add_argument("--reduced", action="store_true",
                   help="CPU-sized variant of the arch")
    p.add_argument("--seed", type=int, default=0)
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, on_step=None, use_pallas_comm=False):
    """Run the trainer; ``on_step(step, metrics, timing)`` sees every
    round's metrics and its times (``ms`` on the host clock; on the GPU
    also ``grad_ms``/``comm_ms`` of device time, and a fleet's
    ``gather_ms``/``scatter_ms``).  ``use_pallas_comm`` selects the legacy
    per-leaf comm route (``TrainerConfig``): a keyword of the API, not a
    flag of the command line, as in the reference.  Returns the final
    state."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the trigger compares f32 norms: keep matmuls in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.hetero is not None and cfg.family in ("audio", "vlm"):
        raise SystemExit(f"--hetero shards are LM-only (token-noise ramp); "
                         f"--arch {args.arch} is family {cfg.family!r}")
    topo = None
    if args.topology is not None:
        from repro_torch.engine import make_topology
        topo = make_topology(args.topology)
    fleet = getattr(topo, "name", None) == "fleet"
    if fleet and (args.fleet_churn or args.fleet_selection != "uniform"):
        from repro_torch.fleet import FleetTopology
        topo = FleetTopology(population=topo.population, cohort=topo.cohort,
                             churn=args.fleet_churn,
                             selection=args.fleet_selection)
    # W = batch-shard count: the cohort for a fleet, the topology's unit
    # count otherwise (--workers by default)
    W = topo.units(args.workers) if topo is not None else args.workers
    if args.cluster is not None:
        from repro_torch.netsim import make_cluster
        # a fleet prices per-CLIENT links (population-sized cluster)
        make_cluster(args.cluster,
                     num_workers=topo.population if fleet else W)
    tcfg = TrainerConfig(algo=args.algo, num_workers=W,
                         lr=args.lr, D=args.D, xi=args.xi,
                         fastpath=args.fastpath, server=args.server,
                         use_pallas_comm=use_pallas_comm)
    policy = tcfg.comm_policy()
    if fleet:
        from repro_torch import fleet as fleet_lib
        state = fleet_lib.init_fleet_state(cfg, tcfg, topo, device=device,
                                           seed=args.seed, policy=policy)
        train_step = fleet_lib.make_fleet_step(cfg, tcfg, topo,
                                               policy=policy,
                                               schedule_seed=args.seed)
    else:
        state = init_state(cfg, tcfg, device=device, seed=args.seed,
                           policy=policy, topology=topo)
        train_step = make_train_step(cfg, tcfg, policy=policy, topology=topo,
                                     schedule_seed=args.seed)
    stream = TokenStream(vocab=cfg.vocab_size, seed=args.seed)
    masks, cohorts, cohort_comm = [], [], []
    t_all = time.perf_counter()
    for step in range(args.steps):
        if step == 0 and policy.needs_rng:
            draws = [policy.draw(k, W, args.seed) for k in range(args.steps)]
            print(f"{policy.name}: sampled uploaders of rounds 0-"
                  f"{args.steps - 1} (seed {args.seed}): {draws}")
        if args.hetero is not None:
            batch = make_heterogeneous_inputs(
                cfg, stream, step, W, args.batch, args.seq, fixed=False,
                h=args.hetero, device=device)
        else:
            batch = make_inputs(cfg, stream, step, args.batch, args.seq,
                                device=device)
        _sync(device)
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        _sync(device)
        timing = dict(ms=(time.perf_counter() - t0) * 1e3, **phase_ms(m))
        if on_step is not None:
            on_step(step, m, timing)
        mask = m["cohort_comm"] if fleet else m["comm_mask"]
        if args.cluster is not None:
            if fleet:
                cohorts.append(m["cohort_ids"].cpu().numpy())
                cohort_comm.append(m["cohort_comm"].cpu().numpy())
            else:
                masks.append(m["comm_mask"].cpu().numpy())
        split = "".join(f" {k} {v:.1f}" for k, v in timing.items()
                        if k != "ms")
        cohort = f" cohort {m['cohort_ids'].tolist()}" if fleet else ""
        print(f"step {step}: loss {float(m['loss']):.6f} | uploads "
              f"{int(m['comm_this_round'])}{cohort} mask "
              f"{mask.to(torch.int32).tolist()} | comm_total "
              f"{int(m['comm_total'])} | {timing['ms']:.1f} ms{split}",
              flush=True)
    dt = time.perf_counter() - t_all
    total = int(state["lag"]["comm_total"])
    rounds = args.steps
    # GD baseline: every lazy unit uploads every round — the whole cohort
    # for a fleet, every worker otherwise
    print(f"done: {rounds} rounds in {dt:.1f}s | uploads {total} vs GD "
          f"{rounds * W} ({100.0 * total / max(rounds * W, 1):.1f}% of GD) "
          f"on {device}")
    if args.cluster is not None and (masks or cohorts):
        t_run, t_gd = price_run(args.cluster, state, cfg, tcfg, topo, W,
                                masks, cohorts, cohort_comm)
        print(f"simulated wall-clock on '{args.cluster}': "
              f"{t_run:.2f}s vs GD {t_gd:.2f}s "
              f"({t_gd / max(t_run, 1e-12):.2f}x advantage)")
    return state


def price_run(cluster, state, cfg, tcfg, topo, W, masks, cohorts,
              cohort_comm):
    """(simulated seconds of the run, of GD on the same rounds) on
    ``cluster``: per client for a fleet, per worker otherwise."""
    from repro_torch.netsim import make_cluster, price_cohort_mask, price_mask
    params = params_of(state, cfg)
    bpu = tcfg.comm_policy().wire_bytes(params)
    dense = float(sum(l.numel() * l.element_size()
                      for l in tree_leaves(params)))
    if getattr(topo, "name", None) == "fleet":
        cl = make_cluster(cluster, num_workers=topo.population)
        ids = np.stack(cohorts)
        cm = np.stack(cohort_comm).astype(bool)
        t_run = price_cohort_mask(ids, cm, bpu, cl, dense_bytes=dense).sum()
        t_gd = price_cohort_mask(ids, np.ones_like(cm), dense, cl,
                                 dense_bytes=dense).sum()
    else:
        cl = make_cluster(cluster, num_workers=W)
        mk = np.stack(masks)
        t_run = price_mask(mk, bpu, cl, dense_bytes=dense).sum()
        t_gd = price_mask(np.ones_like(mk), dense, cl,
                          dense_bytes=dense).sum()
    return float(t_run), float(t_gd)


if __name__ == "__main__":
    main()
