"""Pod-level LAG on the PyTorch port: 2 pods, the cross-pod reduction
SKIPPED on rounds where no pod's gradient changed enough.

  PYTHONPATH=src python examples/torch_pod_lag_multipod.py --steps 60
  PYTHONPATH=src python examples/torch_pod_lag_multipod.py --device cpu

The port of ``examples/pod_lag_multipod.py``.  The reference forces 8 host
devices and a (pod, data, model) mesh; the port's ``pods`` topology runs
in one process on one device, and skips the reduction on a quiet round as
a host branch (``rounds_skipped`` counts those rounds).  The pods see one
fixed heterogeneous batch, so lazy rounds come as the model converges.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.data import TokenStream, make_heterogeneous_inputs
from repro_torch.device import resolve_device
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step, params_of)
from repro_torch.engine.topology import make_topology


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("llama3.2-1b").reduced()
    tcfg = TrainerConfig(algo="lag-wk", num_workers=2, lr=args.lr)
    topology = make_topology("pods:2")
    state = init_state(cfg, tcfg, device=device, seed=0, topology=topology)
    step_fn = make_train_step(cfg, tcfg, topology=topology)
    stream = TokenStream(vocab=cfg.vocab_size, seed=0)
    batch = make_heterogeneous_inputs(cfg, stream, 0, 2, 16, 128,
                                      device=device)

    grad_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params_of(state, cfg)))
    for step in range(args.steps):
        state, m = step_fn(state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:3d} loss {float(m['loss']):.4f} "
                  f"pod-uploads {int(m['comm_this_round'])}/2 "
                  f"round skipped: {bool(m['skipped_round'])}")
    skipped = int(state["lag"]["rounds_skipped"])
    saved = skipped * 2 * grad_bytes * 0.5   # ring all-reduce ≈ 2·(n-1)/n·B
    print(f"\nrounds with ZERO cross-pod traffic: {skipped}/{args.steps} "
          f"(≈{saved / 2**20:.0f} MiB saved for this toy model)")


if __name__ == "__main__":
    main()
