"""Quickstart on the PyTorch port: LAG on the paper's own problem.

  PYTHONPATH=src python examples/torch_quickstart.py               # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port of ``examples/quickstart.py``: LAG-WK matches batch GD's
iteration count while cutting worker→server uploads by an order of
magnitude when the workers' smoothness constants are heterogeneous (paper
Fig. 3 / Table 5).  The problem is float64, as the reference's x64 run, so
every policy takes the plain route (the float32 comm plane's kernels serve
float32 problems); LAQ's savings show in bytes.

Everything goes through ``repro_torch.engine.Experiment``: any policy
(``algo=``) × server optimizer (``server=``) × topology.  Next step:
``examples/torch_train_lag_llm.py``, the same algorithms in the deep
trainer.
"""
import argparse

import torch

from repro_torch.core import convex
from repro_torch.engine import Experiment


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--steps", type=int, default=3000)
    args = p.parse_args(argv)

    # 9 workers, increasing smoothness L_m = (1.3^{m-1}+1)², the paper's
    problem = convex.synthetic("linreg", num_workers=9, seed=0,
                               dtype=torch.float64, device=args.device)
    print(f"worker smoothness L_m: "
          f"{[round(float(l), 1) for l in problem.L_m]}")

    eps = 1e-8
    results = {}
    for algo in ("gd", "lag-wk", "lag-ps", "cyc-iag", "num-iag"):
        r = results[algo] = Experiment(problem=problem, algo=algo,
                                       steps=args.steps).run()
        print(f"{algo:8s}  iterations to 1e-8: {str(r.iters_to(eps)):>6s}"
              f"   uploads to 1e-8: {str(r.comms_to(eps)):>6s}")

    print("\nLemma 4 in action — uploads per worker over the first 500 "
          "rounds (L_m increasing left to right):")
    print("  " + " ".join(f"{int(u):4d}" for u in
                          results["lag-wk"].comm_mask[:500].sum(0)))

    # LAQ: the same trigger, b-bit quantized uploads: savings in BYTES
    r_laq = Experiment(problem=problem, algo="laq@4", steps=args.steps).run()
    print(f"\nwire bytes to 1e-8:  lag-wk "
          f"{results['lag-wk'].bytes_to(eps):>9.0f}   laq@4 "
          f"{r_laq.bytes_to(eps):>9.0f}")


if __name__ == "__main__":
    main()
