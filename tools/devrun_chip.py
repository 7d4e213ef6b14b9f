"""Run ``chip_smoke.py``'s phase 23 (the device plane) alone, with what it
needs: the kernels built (phase 2) and phase 5's ``shards:2`` lag-wk and
laq@4 runs as its oracle.  One card:

    python3 tools/devrun_chip.py

Prints phase 5's and phase 23's lines, the card's ``nvidia-smi`` name and
power limit; exits non-zero when a check fails.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.fastpath import kernels
    from repro_torch.kernels import build
    from repro_torch.kernels.lag_trigger import lag_trigger as lt

    if not torch.cuda.is_available():
        print("devrun_chip: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power_limit()
    print(torch.cuda.get_device_name(0), smi)
    t0 = time.perf_counter()
    build.build([kernels.LIBRARY, lt.LIBRARY])
    print(f"built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    runs = {algo: cs.trainer_phase(torch, algo,
                                   digest_after=cs.DEVICES_STEPS)
            for algo in ("lag-wk", "laq@4")}
    launches = {}
    cs.phase23(torch, dev, runs, launches, smi)
    print(f"devrun_chip: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        cs.stop_children()
