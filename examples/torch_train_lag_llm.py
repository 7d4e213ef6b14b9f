"""End to end on the PyTorch port: train a ~100M llama-style model with
LAG and compare uploads against plain synchronous GD.

  PYTHONPATH=src python examples/torch_train_lag_llm.py --steps 300
  PYTHONPATH=src python examples/torch_train_lag_llm.py --algo laq@4
  PYTHONPATH=src python examples/torch_train_lag_llm.py --bfloat16
  PYTHONPATH=src python examples/torch_train_lag_llm.py --device cpu \
      --steps 3 --layers 1 --workers 2 --batch 4 --seq 32

The port of ``examples/train_lag_llm.py``: llama3.2-1b's family at d_model
1024 (~100M parameters at the default 4 × 2 layers).  Workers see
heterogeneous data shards (different stream noise), the regime where
LAG's trigger pays off (paper Lemma 4).  On the card the round runs on the
batched comm plane's CUDA kernels; ``--bfloat16`` trains the bfloat16
config (θ, ∇ and ĝ in bfloat16, the kernels' bfloat16 instantiations).
"""
import argparse
import time

from repro_torch.configs import get_config
from repro_torch.data import TokenStream, make_heterogeneous_inputs
from repro_torch.device import resolve_device
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step, params_of)
from repro_torch.core.tree import tree_leaves


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--algo", default="lag-wk")
    p.add_argument("--laq-bits", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--bfloat16", action="store_true",
                   help="train the bfloat16 config")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    kw = dict(dtype="bfloat16", param_dtype="bfloat16") if args.bfloat16 \
        else {}
    # ~100M params: llama family at d_model 1024, d_ff 4096, 32k vocab
    cfg = get_config("llama3.2-1b", num_layers=args.layers * 2,
                     d_model=1024, d_ff=4096, num_heads=16, num_kv_heads=4,
                     head_dim=64, vocab_size=32768, **kw)
    tcfg = TrainerConfig(algo=args.algo, num_workers=args.workers,
                         lr=args.lr, laq_bits=args.laq_bits)
    state = init_state(cfg, tcfg, device=device, seed=0)
    n_params = sum(t.numel() for t in tree_leaves(params_of(state, cfg)))
    print(f"model: llama-family {cfg.num_layers}L d{cfg.d_model} "
          f"{cfg.param_dtype} → {n_params / 1e6:.0f}M params on {device}")
    step_fn = make_train_step(cfg, tcfg)
    stream = TokenStream(vocab=cfg.vocab_size, seed=0)

    t0 = time.time()
    for step in range(args.steps):
        batch = make_heterogeneous_inputs(cfg, stream, step, args.workers,
                                          args.batch, args.seq, fixed=True,
                                          device=device)
        state, m = step_fn(state, batch)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(m['loss']):.4f}  "
                  f"uploads {int(m['comm_this_round'])}/{args.workers}  "
                  f"total {int(m['comm_total'])}  "
                  f"({time.time() - t0:.0f}s)")
    total = int(state["lag"]["comm_total"])
    gd_total = args.steps * args.workers
    print(f"\nuploads: {total} vs GD {gd_total} "
          f"→ {100 * total / gd_total:.1f}% of synchronous GD")
    print("per-worker uploads:", state["lag"]["comm_per_worker"].tolist())
    # policy-declared wire traffic: LAQ's b-bit payloads vs dense GD
    params = params_of(state, cfg)
    bpu = tcfg.comm_policy().wire_bytes(params)
    dense = TrainerConfig(algo="gd").comm_policy().wire_bytes(params)
    print(f"wire bytes: {total * bpu / 2**20:.1f} MiB "
          f"({bpu / 2**20:.2f} MiB/upload) vs GD "
          f"{gd_total * dense / 2**20:.1f} MiB "
          f"→ {100 * total * bpu / (gd_total * dense):.1f}%")


if __name__ == "__main__":
    main()
