"""Time the bfloat16 trainings of ``chip_smoke.py``'s phase 19b alone, under
both settings of PyTorch's bfloat16 reduced-precision matmul reductions.

``repro_torch.launch.train`` and ``chip_smoke.py`` turn
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` off on
the card (PyTorch's default is on).  This script runs, in one process on one
card, without the smoke's earlier phases:

1. each ``chip_smoke.BF16_TRAIN`` training (llama3.2-1b at full width and
   depth, W = 2, batch 4, seq 256, 4 rounds) with the setting off, on the
   plane and on the card's plain route: the smoke's run lines, the largest
   |Δ loss| plane vs plain route with the masks compared, and the dry-run's
   reckoned peak beside ``torch.cuda.max_memory_allocated``;
2. the bfloat16 lag-wk training on the plane with the setting on, off, on,
   off: which fwd/bwd reading belongs to which setting;
3. a ``torch.profiler`` trace of one round of bfloat16 lag-wk and of the
   float32 one after two untraced rounds (setting off): the device's busy
   ms and idle share of the round, and its kernels by device time.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/bf16_train_timing.py
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bf16_train_timing: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.dist.lag_trainer import TrainerConfig

    print(gpu_name_and_power_limit(), flush=True)
    mm = torch.backends.cuda.matmul
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    for arch, ckw, tkw in cs.BF16_TRAIN:
        cfg = get_config(arch, **ckw)
        tcfg = TrainerConfig(num_workers=2, lr=0.3, **tkw)
        label = " ".join([arch, "bfloat16" if ckw else "float32"]
                         + [f"{k}={v}" for k, v in tkw.items()])
        plane = cs.bf16_train_run(torch, cfg, tcfg)
        plain = cs.bf16_train_run(torch, cfg, tcfg, plain=True)
        print(cs.run_line(label + " plane", plane))
        print(cs.run_line(label + " plain route", plain))
        dl = max(abs(a["loss"] - b["loss"])
                 for a, b in zip(plane["rounds"], plain["rounds"]))
        same = [r["mask"] for r in plane["rounds"]] \
            == [r["mask"] for r in plain["rounds"]]
        reckoned = cs.reckoned_peak_gb(cfg, tcfg)
        print(f"  {label}: plane vs plain route max |Δ loss| {dl:.4g}, "
              f"masks equal {same} | peak reckoned {reckoned:.2f} GB, "
              f"measured {plane['peak']:.2f} GB, ratio "
              f"{plane['peak'] / reckoned:.4f}", flush=True)
    cfg = get_config("llama3.2-1b", **cs.BF16)
    tcfg = TrainerConfig(algo="lag-wk", num_workers=2, lr=0.3)
    for on in (True, False, True, False):
        mm.allow_bf16_reduced_precision_reduction = on
        run = cs.bf16_train_run(torch, cfg, tcfg)
        print(cs.run_line(f"llama3.2-1b bfloat16 lag-wk plane, "
                          f"allow_bf16_reduced_precision_reduction={on}",
                          run), flush=True)
    for ckw in (cs.BF16, {}):
        traced_round(torch, get_config("llama3.2-1b", **ckw), tcfg)
    return 0


def traced_round(torch, cfg, tcfg, top=12):
    """Trace the third round of ``cfg`` at W = 2, batch 4, seq 256 on the
    plane: the round's wall ms, the device's busy ms (the union of its
    kernels' intervals) and idle share, and the ``top`` kernels."""
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.dist import lag_trainer as lt
    from repro_torch.launch.profile_comm import _kernel_times

    state = lt.init_state(cfg, tcfg, device="cuda", seed=0)
    step = lt.make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size)
    for k in range(2):
        state, _ = step(state, make_inputs(cfg, stream, k, 4, 256,
                                           device="cuda"))
    batch = make_inputs(cfg, stream, 2, 4, 256, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_name = _kernel_times(prof)
    print(f"  traced round 2, {cfg.arch_id} {cfg.params_dtype} "
          f"{tcfg.algo}: wall {wall:.1f} ms (profiler on), device busy "
          f"{busy:.1f} ms, idle {100 * (1 - busy / wall):.1f} %, "
          f"{sum(c for _, c in by_name.values())} kernels; "
          f"{lt.phase_ms(m)}")
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:9.3f} ms {n:5d}x {name[:110]}")
    del state, step
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
