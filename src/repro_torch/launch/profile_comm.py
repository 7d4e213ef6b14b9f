"""Device-time breakdown of the comm phase of a LAG round, per comm route.

  python -m repro_torch.launch.profile_comm --algos lag-wk,laq@4 --steps 3
  python -m repro_torch.launch.profile_comm --algos lag-adam --lr 1e-3
  python -m repro_torch.launch.profile_comm --algos lag-wk \
      --server prox-l1@1e-6

Trains llama3.2-1b at full width on the GPU (``--workers 2 --batch 4 --seq
256 --lr 0.3`` by default, seed 0) once on the batched plane and once on
the legacy per-leaf route (``use_pallas_comm=True``) for each policy (any
``launch.train`` spec: ``lasg-wk``, ``cyc-laq@4``, ``num-iag``, …; a GD
payload under a schedule takes the plain route on both), with the server
step ``--server`` (default: the algo's), and traces the
comm phase (``engine.rounds.lag_round``: policy rounds, worker sum, server
step) of the last round with ``torch.profiler``.  Prints, per route, the
comm phase's device time (CUDA events), the busy time of the kernels in it
and the idle share, then the kernels' device time summed by name.  Needs
a CUDA GPU; the numbers are of the card it runs on.
"""
from __future__ import annotations

import argparse
from collections import defaultdict

import torch

from repro_torch.engine import rounds as engine_rounds
from repro_torch.launch import train


def _kernel_times(prof):
    """(busy ms: the union of the kernels' intervals, {name: (ms,
    count)}) of the device events in a finished trace."""
    spans, by_name = [], defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_name[e.name][0] += (t1 - t0) / 1e3
        by_name[e.name][1] += 1
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e3, dict(by_name)


def profile_route(algo: str, legacy: bool, argv, top: int) -> None:
    """Train ``steps`` rounds; trace the comm phase of the last one."""
    steps = int(argv[argv.index("--steps") + 1])
    real = engine_rounds.lag_round
    seen = []

    def traced(*a, **k):
        seen.append(None)
        if len(seen) < steps:
            return real(*a, **k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            start.record()
            out = real(*a, **k)
            end.record()
            torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        busy, by_name = _kernel_times(prof)
        route = "legacy per-leaf route" if legacy else "batched plane"
        idle = f"{100 * (1 - busy / ms):.1f} %" if by_name else \
            "not measured (the trace holds no device events)"
        print(f"{algo} on the {route}: comm phase {ms:.3f} ms (CUDA "
              f"events), kernels busy {busy:.3f} ms, device idle {idle}")
        rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        for name, (t, n) in rows[:top]:
            print(f"  {t:9.3f} ms  {n:4d}x  {name[:110]}")
        rest = rows[top:]
        if rest:
            print(f"  {sum(t for _, (t, _) in rest):9.3f} ms  "
                  f"{sum(n for _, (_, n) in rest):4d}x  ({len(rest)} other "
                  f"kernels)")
        return out

    engine_rounds.lag_round = traced
    try:
        train.main(argv, use_pallas_comm=legacy)
    finally:
        engine_rounds.lag_round = real


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--algos", default="lag-wk,lag-ps,laq@4")
    p.add_argument("--workers", default="2")
    p.add_argument("--batch", default="4")
    p.add_argument("--seq", default="256")
    p.add_argument("--steps", default="3")
    p.add_argument("--lr", default="0.3")
    p.add_argument("--server", default=None,
                   help="server-optimizer spec ('momentum@0.9', "
                        "'prox-l1@1e-6', adam)")
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    for algo in args.algos.split(","):
        for legacy in (False, True):
            server = [] if args.server is None else ["--server",
                                                      args.server]
            profile_route(algo, legacy, [
                "--arch", args.arch, "--algo", algo, "--workers",
                args.workers, "--batch", args.batch, "--seq", args.seq,
                "--steps", args.steps, "--lr", args.lr, "--seed", "0"]
                + server, args.top)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
