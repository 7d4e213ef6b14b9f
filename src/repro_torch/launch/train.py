"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --algo lag-wk --workers 2 --batch 4 --seq 256 --steps 4

Runs on the GPU (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` asks for the CPU.  Prints the loss and the LAG
communication counters of every round, and the time per round (the host
clock around work that ends in a device synchronise).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import TokenStream, make_inputs
from repro_torch.device import resolve_device
from repro_torch.dist.lag_trainer import (ALGOS, TrainerConfig, init_state,
                                          make_train_step, phase_ms)


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
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.3)
    p.add_argument("--xi", type=float, default=0.1)
    p.add_argument("--D", type=int, default=10)
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
    also ``grad_ms``/``comm_ms`` of device time).  ``use_pallas_comm``
    selects the legacy per-leaf comm route (``TrainerConfig``): a keyword
    of the API, not a flag of the command line, as in the reference.
    Returns the final state."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the trigger compares f32 norms: keep matmuls in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(algo=args.algo, num_workers=args.workers,
                         lr=args.lr, D=args.D, xi=args.xi,
                         fastpath=args.fastpath, server=args.server,
                         use_pallas_comm=use_pallas_comm)
    policy = tcfg.comm_policy()
    state = init_state(cfg, tcfg, device=device, seed=args.seed,
                       policy=policy)
    train_step = make_train_step(cfg, tcfg, policy=policy,
                                 schedule_seed=args.seed)
    stream = TokenStream(vocab=cfg.vocab_size, seed=args.seed)
    t_all = time.perf_counter()
    for step in range(args.steps):
        if step == 0 and policy.needs_rng:
            draws = [policy.draw(k, args.workers, args.seed)
                     for k in range(args.steps)]
            print(f"{policy.name}: sampled uploaders of rounds 0-"
                  f"{args.steps - 1} (seed {args.seed}): {draws}")
        batch = make_inputs(cfg, stream, step, args.batch, args.seq,
                            device=device)
        _sync(device)
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        _sync(device)
        timing = dict(ms=(time.perf_counter() - t0) * 1e3, **phase_ms(m))
        if on_step is not None:
            on_step(step, m, timing)
        split = "".join(f" {k} {v:.1f}" for k, v in timing.items()
                        if k != "ms")
        print(f"step {step}: loss {float(m['loss']):.6f} | uploads "
              f"{int(m['comm_this_round'])} mask "
              f"{m['comm_mask'].to(torch.int32).tolist()} | comm_total "
              f"{int(m['comm_total'])} | {timing['ms']:.1f} ms{split}",
              flush=True)
    dt = time.perf_counter() - t_all
    total = int(state["lag"]["comm_total"])
    print(f"done: {args.steps} rounds in {dt:.1f}s | uploads {total} vs GD "
          f"{args.steps * args.workers} on {device}")
    return state


if __name__ == "__main__":
    main()
