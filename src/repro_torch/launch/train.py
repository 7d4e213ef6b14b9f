"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --algo lag-wk --workers 2 --batch 4 --seq 256 --steps 4 \\
      --hetero 0.8 --cluster hetero:2@10ms/1Gbps

``--arch`` takes every architecture of the port (``repro_torch.configs``:
the dense block kind, with the audio and VLM batches of hubert-xlarge and
qwen2-vl-7b, recurrentgemma-9b, mamba2-370m, and the MoE pair
qwen3-moe-30b-a3b and qwen3-moe-235b-a22b, whose loss adds 0.01 × the
load-balance loss); ``--layers n`` cuts the depth (recurrentgemma at 5:
one superblock and the two-layer tail), ``--reduced`` the widths.
Runs on the GPU (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` asks for the CPU.  Prints the loss and the LAG
communication counters of every round, and the time per round (the host
clock around work that ends in a device synchronise).

``--topology`` selects the placement (``repro_torch.engine.topology``
specs): ``shards`` (default), ``pods:2`` (quiet rounds skip the
reduction), ``async:4@2`` (bounded staleness), or the sampled-cohort fleet
``fleet:100000@64`` (``repro_torch.fleet``; ``--fleet-churn`` and
``--fleet-selection`` dial dropout and lazy client selection), or the
serverless gossip graph ``graph:9@ring`` (``repro_torch.graph``: W is the
node count, the lazy units are the E directed edges), or the device plane
``devices:D`` (``repro_torch.devrun``: one worker a rank, the policies'
packed wire gathered between ranks).  Under ``devices:D`` the launcher
joins the caller's group (a torchrun group: ``RANK``/``WORLD_SIZE`` set)
or spawns D ranks itself over a ``FileStore`` in a temporary directory;
``--dist-backend`` is ``nccl`` (one card a rank; the default on the card)
or ``gloo`` (the default for ``--device cpu``; on the card, ranks share
it and the wire goes through host memory).  Rank 0 prints, logs, prices
``--cluster`` and writes the checkpoints (the ``shards:D`` file; every
rank restores its own worker's rows).  ``--hetero`` dials
the worker shards' data heterogeneity (``repro_torch.netsim.hetero``);
``--cluster`` prices the run's uploads on a simulated network
(``repro_torch.netsim.cluster``: per worker, per client for a fleet, per
directed edge for a graph) and prints the simulated wall-clock against
GD's.

``--mesh host`` (the default, as in the reference) is the host mesh: with
``--ranks N`` (or inside a ``torchrun`` group, ``RANK``/``WORLD_SIZE``
set) the launcher runs ``--topology shards`` on a (N, 1) ``("data",
"model")`` mesh of N ranks (``repro_torch.dist.row_shards``: rank r owns
workers r·W/N…, each rank holds 1/N of the rows of ĝ, θ̂, LAQ's residual
and ∇, θ and the server's state whole); ``--dist-backend`` as for
``devices:D``, rank 0 prints, logs, prices ``--cluster`` and writes the
checkpoints (the ``shards:W`` file; every rank restores its rows).  Alone
(one process, no group) the host mesh is today's one-process trainer.
``--mesh prod`` / ``prod2`` (the reference's 16×16 and 2×16×16 TPU
meshes, a model axis of 16) are refused by name: the port runs no tensor
parallelism.

``--log run.jsonl`` appends a JSON line at every 10th round and the last
(``repro_torch.metrics.Logger``); ``--ckpt-dir D --ckpt-every n`` saves
the whole state every n rounds (``repro_torch.checkpoint``), and
``--resume`` restarts from the newest checkpoint in D.  The data and the
draws are keyed by the round, so a resumed run is bit for bit the
uninterrupted one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from repro_torch import metrics as metrics_lib
from repro_torch.checkpoint import latest_step, restore, save
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
                        "'fleet:100000@64', 'graph:9@ring', 'devices:2'); "
                        "default: flat batch shards.  devices:D runs one "
                        "worker per rank of D (spawned here, or the caller's "
                        "torchrun group).  fleet:N@k samples a k-client cohort "
                        "per round from N clients (W is then k); "
                        "graph:W@<family> is the serverless gossip plane "
                        "(families ring, torus:RxC, complete, expander:d, "
                        "smallworld:k@p; W nodes, a lazy trigger per "
                        "directed edge)")
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
                        "W, the population for a fleet, the directed edge "
                        "count E for a graph)")
    p.add_argument("--fastpath", default="auto", choices=["auto", "on"],
                   help="batched flat-buffer comm plane: auto = on for CUDA "
                        "tensors (the per-leaf oracle on the CPU), on = "
                        "forced (plain kernel versions on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="devices:D or --ranks N: the ranks' backend "
                        "(default nccl on the card, one card a rank; gloo "
                        "for --device cpu, or ranks sharing a card)")
    p.add_argument("--mesh", default="host", choices=["host", "prod", "prod2"],
                   help="host (default): the (ranks, 1) data x model mesh, "
                        "the LAG state row-sharded over the ranks; prod / "
                        "prod2 (the reference's 16x16 / 2x16x16 TPU meshes) "
                        "are refused: no tensor parallelism")
    p.add_argument("--ranks", type=int, default=1,
                   help="--mesh host: spawn this many ranks (or join a "
                        "torchrun group of as many); 1 without a group: "
                        "the one-process trainer")
    p.add_argument("--reduced", action="store_true",
                   help="CPU-sized variant of the arch")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the arch to this many layers (its widths "
                        "kept)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log", default=None,
                   help="append a JSON line per logged round (every 10th "
                        "and the last) to this file")
    p.add_argument("--ckpt-dir", default=None,
                   help="directory of step_<n>.npz checkpoints")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="save the state every n rounds (0: never)")
    p.add_argument("--resume", action="store_true",
                   help="restart from the newest checkpoint in --ckpt-dir")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, on_step=None, use_pallas_comm=False):
    """Run the trainer; ``on_step(step, metrics, timing)`` sees every
    round's metrics and its times (``ms`` on the host clock; on the GPU
    also ``grad_ms``/``comm_ms`` of device time, a fleet's
    ``gather_ms``/``scatter_ms``, a graph's ``mix_ms``).
    ``use_pallas_comm`` selects the legacy per-leaf comm route
    (``TrainerConfig``): a keyword of the API, not a flag of the command
    line, as in the reference.  Returns the final state (this rank's under
    ``devices:D``; None where the launcher spawned the ranks itself, each
    of which runs this function, ``on_step`` on none of them)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the trigger compares f32 norms: keep matmuls in full float32 (and
        # any bfloat16 product's sums in float32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
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
    graph = getattr(topo, "name", None) == "graph"
    devices = getattr(topo, "name", None) == "devices"
    lead, joined, mesh = True, False, None
    if args.mesh != "host":
        from repro_torch.dist import row_shards
        raise SystemExit(
            f"--mesh {args.mesh} is the reference's "
            f"{'2x16x16' if args.mesh == 'prod2' else '16x16'} TPU mesh "
            f"({512 if args.mesh == 'prod2' else 256} ranks, a model axis of "
            f"16): tensor parallelism is not ported "
            f"({row_shards.ITEM_TENSOR_PARALLEL}); --mesh host runs the data "
            f"axis")
    meshed = not devices and (args.ranks > 1 or _in_group())
    if meshed and topo is not None and topo.name != "shards":
        from repro_torch.dist import row_shards
        raise SystemExit(
            f"--mesh host at more than one rank runs --topology shards; "
            f"--topology {args.topology} under the host mesh is not ported "
            f"({row_shards.ITEM_TOPOLOGIES})")
    if devices and args.ranks > 1:
        raise SystemExit("--ranks is for --mesh host: devices:D spawns its D "
                         "ranks itself")
    if devices or meshed:
        import torch.distributed as dist
        from repro_torch import devrun
        ranks = topo.num_devices(args.workers) if devices else args.ranks
        if not dist.is_initialized():
            backend = args.dist_backend or ("gloo" if device.type == "cpu"
                                            else "nccl")
            if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
                devrun.launch(_train_rank, ranks, backend=backend,
                              args=(argv, use_pallas_comm), device=device,
                              threads=max(1, (os.cpu_count() or 1) // ranks)
                              if device.type == "cpu" else None,
                              timeout=float("inf"))
                return None
            devrun.check_backend(backend, int(os.environ["WORLD_SIZE"]),
                                 device)
            dist.init_process_group(backend)
            joined = True
        if meshed:
            if args.ranks > 1 and dist.get_world_size() != args.ranks:
                raise SystemExit(f"--ranks {args.ranks} in a group of "
                                 f"{dist.get_world_size()} ranks")
            from repro_torch.dist import row_shards
            from repro_torch.launch.mesh import make_host_mesh
            mesh = make_host_mesh("cuda" if dist.get_backend() == "nccl"
                                  else "cpu")
            device = devrun.rank_device(device)
        lead = dist.get_rank() == 0
        if not lead:
            on_step = None
    elif args.dist_backend is not None:
        raise SystemExit("--dist-backend is for --topology devices:D or "
                         "--ranks N")
    if fleet and (args.fleet_churn or args.fleet_selection != "uniform"):
        from repro_torch.fleet import FleetTopology
        topo = FleetTopology(population=topo.population, cohort=topo.cohort,
                             churn=args.fleet_churn,
                             selection=args.fleet_selection)
    # W = batch-shard count: the cohort for a fleet, the node count for a
    # graph, the topology's unit count otherwise (--workers by default)
    W = topo.units(args.workers) if topo is not None else args.workers
    # the lazy units a round: the E directed edges of a graph, W otherwise
    units = topo.num_edges if graph else W
    if args.cluster is not None:
        from repro_torch.netsim import make_cluster
        # a fleet prices per-CLIENT links (population-sized cluster), a
        # graph per directed edge
        make_cluster(args.cluster,
                     num_workers=topo.population if fleet else units)
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
    elif graph:
        from repro_torch import graph as graph_lib
        state = graph_lib.init_graph_state(cfg, tcfg, topo, device=device,
                                           seed=args.seed, policy=policy)
        train_step = graph_lib.make_graph_step(cfg, tcfg, topo,
                                               policy=policy,
                                               schedule_seed=args.seed)
    elif devices:
        state = devrun.init_device_state(cfg, tcfg, device=device,
                                         seed=args.seed, policy=policy,
                                         topology=topo)
        device = state["theta"].device
        train_step = devrun.make_device_step(cfg, tcfg, policy=policy,
                                             topology=topo,
                                             schedule_seed=args.seed)
    else:
        state = init_state(cfg, tcfg, device=device, seed=args.seed,
                           policy=policy, topology=topo, mesh=mesh)
        train_step = make_train_step(cfg, tcfg, policy=policy, topology=topo,
                                     schedule_seed=args.seed, mesh=mesh)
    say = print if lead else (lambda *a, **kw: None)
    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) \
            is not None:
        if devices:
            state, start = devrun.restore_checkpoint(args.ckpt_dir, state,
                                                     policy)
        elif mesh is not None:
            state, start = row_shards.restore_checkpoint(args.ckpt_dir,
                                                         state, cfg, mesh)
        else:
            state, start = restore(args.ckpt_dir, state)
        say(f"resumed from step {start}")
    stream = TokenStream(vocab=cfg.vocab_size, seed=args.seed)
    log = metrics_lib.Logger(args.log if lead else None, echo=lead)
    masks, cohorts, cohort_comm = [], [], []
    t_all = time.perf_counter()
    for step in range(start, args.steps):
        if step == start and policy.needs_rng:
            draws = [policy.draw(k, units, args.seed)
                     for k in range(start, args.steps)]
            say(f"{policy.name}: sampled uploaders of rounds {start}-"
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
        if "gather_ms" in m:
            timing["gather_ms"] = m["gather_ms"]
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
        say(f"step {step}: loss {float(m['loss']):.6f} | uploads "
            f"{int(m['comm_this_round'])}{cohort} mask "
            f"{mask.to(torch.int32).tolist()} | comm_total "
            f"{int(m['comm_total'])} | {timing['ms']:.1f} ms{split}",
            flush=True)
        if step % 10 == 0 or step == args.steps - 1:
            log.log(step, loss=m["loss"], comm_round=m["comm_this_round"],
                    comm_total=m["comm_total"])
        if args.ckpt_every and args.ckpt_dir \
                and (step + 1) % args.ckpt_every == 0:
            if devices:
                devrun.save_checkpoint(args.ckpt_dir, step + 1, state,
                                       policy)
            elif mesh is not None:
                row_shards.save_checkpoint(args.ckpt_dir, step + 1, state,
                                           cfg, mesh)
            else:
                save(args.ckpt_dir, step + 1, state)
    log.close()
    dt = time.perf_counter() - t_all
    total = int(state["lag"]["comm_total"])
    rounds = args.steps - start
    # GD baseline: every lazy unit uploads every round — the whole cohort
    # for a fleet, every directed edge for a graph, every worker otherwise
    # — over this run's rounds (the reference's figure: after a resume the
    # upload counter still counts from step 0)
    gd = rounds * units
    say(f"done: {rounds} rounds in {dt:.1f}s | uploads {total} vs GD "
        f"{gd} ({100.0 * total / max(gd, 1):.1f}% of GD) on {device}")
    if joined:
        dist.destroy_process_group()
    if lead and args.cluster is not None and (masks or cohorts):
        t_run, t_gd = price_run(args.cluster, state, cfg, tcfg, topo, W,
                                masks, cohorts, cohort_comm)
        print(f"simulated wall-clock on '{args.cluster}': "
              f"{t_run:.2f}s vs GD {t_gd:.2f}s "
              f"({t_gd / max(t_run, 1e-12):.2f}x advantage)")
    return state


def _in_group() -> bool:
    """True inside an initialised group or a torchrun one to join."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()) or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)


def _train_rank(rank, argv, use_pallas_comm):
    """A spawned rank of ``devices:D`` or ``--ranks N``: the launcher
    again, inside the group (``devrun.launch`` has initialised it)."""
    main(argv, use_pallas_comm=use_pallas_comm)


def price_run(cluster, state, cfg, tcfg, topo, W, masks, cohorts,
              cohort_comm):
    """(simulated seconds of the run, of GD on the same rounds) on
    ``cluster``: per client for a fleet, per directed edge for a graph
    (one node's iterate moves per edge), per worker otherwise."""
    from repro_torch.netsim import (make_cluster, price_cohort_mask,
                                    price_edge_mask, price_mask)
    graph = getattr(topo, "name", None) == "graph"
    if graph:
        from repro_torch.graph import node_params
        params = node_params(state, cfg)
    else:
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
    elif graph:
        mk, dst = np.stack(masks), topo.spec.edge_dst
        cl = make_cluster(cluster, num_workers=topo.num_edges)
        t_run = price_edge_mask(mk, bpu, cl, dst, dense_bytes=dense).sum()
        t_gd = price_edge_mask(np.ones_like(mk), dense, cl, dst,
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
