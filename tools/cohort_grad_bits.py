"""Count the fleet cohorts' gradient rows that are not bitwise the same
rows of the population's gradient, at θ⁰, on a device.

    PYTHONPATH=src python3 tools/cohort_grad_bits.py [cuda|cpu]

``fleet_problem("linreg", num_clients=200)`` (the card test
``test_cuda_convex_fleet_matches_cpu``'s problem): 20 cohorts of 8 drawn
from a seeded ``torch.Generator``.  Prints how many of their 160 rows
differ from the population's when the cohort's gradient is its own
batched product (the cohort's data gathered first), and when it is the
cohort's rows of the population's product (what the convex fleet takes).
A nonzero count is a round-0 innovation of a few ulps that the fleet's
first trigger would read.
"""
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import fleet  # noqa: E402


def main(dev):
    prob = fleet.fleet_problem("linreg", num_clients=200, device=dev)
    theta0 = torch.zeros(prob.dim, device=dev, dtype=prob.X.dtype)
    full = prob.worker_grads(theta0)
    gen = torch.Generator().manual_seed(0)
    own = rows = 0
    for _ in range(20):
        ids = torch.randperm(200, generator=gen)[:8].to(dev)
        sub = dataclasses.replace(prob, X=prob.X[ids], y=prob.y[ids])
        own += int((sub.worker_grads(theta0) != full[ids]).any(dim=1).sum())
        rows += int((prob.worker_grads(theta0)[ids] != full[ids])
                    .any(dim=1).sum())
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"{name}: X {tuple(prob.X.shape)} {prob.X.dtype}; cohort rows "
          f"that differ from the population's at theta0: {own} of 160 "
          f"(the cohort's own product), {rows} of 160 (the population "
          f"product's rows)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
