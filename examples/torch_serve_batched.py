"""Serving on the PyTorch port: prefill a batch of prompts, then batched
greedy decode with the KV / recurrent caches, for any decoder arch.

  PYTHONPATH=src python examples/torch_serve_batched.py --arch mamba2-370m
  PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

The port of ``examples/serve_batched.py``, on the reduced config as
there.  On the card ``--use-pallas`` runs the prefill's RMSNorm and flash
attention through the port's CUDA kernels (the plain versions on the CPU);
``--bfloat16`` serves the bfloat16 config.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import applicable
from repro_torch.device import resolve_device
from repro_torch.models import model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--use-pallas", action="store_true",
                   help="the prefill's RMSNorm and flash attention through "
                        "the kernels")
    p.add_argument("--bfloat16", action="store_true",
                   help="serve the bfloat16 config")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    kw = dict(dtype="bfloat16", param_dtype="bfloat16") if args.bfloat16 \
        else {}
    cfg = get_config(args.arch, use_pallas=args.use_pallas, **kw).reduced()
    ok, reason = applicable(cfg, "decode_32k")
    if not ok:
        raise SystemExit(f"{args.arch}: {reason}")
    params = model.init(cfg, device=device, seed=0)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32).to(device)
    max_len = args.prompt_len + args.gen

    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        last, cache = model.prefill(params, cfg, {"tokens": prompts},
                                    max_len=max_len)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(last, -1)[:, None].to(torch.int32)
        generated = [tok]
        t0 = time.perf_counter()
        for t in range(args.prompt_len, max_len - 1):
            logits, cache = model.decode_step(params, cfg, cache,
                                              generated[-1], t)
            generated.append(torch.argmax(logits[:, -1], -1)[:, None]
                             .to(torch.int32))
        out = torch.cat(generated, dim=1)
        _sync(device)
        t_decode = time.perf_counter() - t0

    print(f"arch={args.arch} (reduced) batch={args.batch} on {device}")
    print(f"prefill {args.prompt_len} tokens: {t_prefill * 1e3:.1f} ms")
    print(f"decode {out.shape[1]} tokens: {t_decode * 1e3:.1f} ms "
          f"({t_decode / max(out.shape[1] - 1, 1) * 1e3:.2f} ms/token)")
    for b in range(min(args.batch, 2)):
        print(f"  seq[{b}]: {out[b, :12].tolist()} ...")


if __name__ == "__main__":
    main()
