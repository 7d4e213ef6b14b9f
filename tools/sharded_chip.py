"""Run ``chip_smoke.py``'s phase 24 (the host mesh: the LAG state
row-sharded over data ranks) alone, with what it needs: the comm plane's
kernels built and phase 5's ``shards:2`` lag-wk and laq@4 runs as 24a's
oracle.  One card:

    python3 tools/sharded_chip.py

Prints phase 5's and phase 24's lines, the card's ``nvidia-smi`` name and
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

    if not torch.cuda.is_available():
        print("sharded_chip: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power_limit()
    print(torch.cuda.get_device_name(0), smi)
    t0 = time.perf_counter()
    build.build([kernels.LIBRARY])
    print(f"built in {time.perf_counter() - t0:.1f} s")
    runs = {algo: cs.trainer_phase(torch, algo, digest_after=cs.MESH_STEPS)
            for algo in ("lag-wk",)}
    launches = {}
    cs.phase24(torch, runs, launches, smi)
    print(f"sharded_chip: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        cs.stop_children()
