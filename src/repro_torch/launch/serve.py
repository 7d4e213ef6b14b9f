"""Serving launcher of the port: batched greedy decoding after a prefill.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 4 --prompt-len 2048 --gen 32 --rounds 2

Each round prefills a random prompt batch (last-position logits and the KV
cache), then takes ``gen - 1`` greedy decode steps against the cache, and
prints the prefill ms, the decode ms and the ms per token (the host clock
around work that ends in a device synchronise).  Runs on the GPU
(``--device cuda``, the default) and raises when there is none;
``--device cpu`` asks for the CPU.  The model serves with
``use_pallas=True``: on the GPU its prefill runs the hand-written RMSNorm
and flash-attention kernels, on the CPU their plain versions.  Every
architecture of the port with a decode step serves (the VLM on text
prompts, its M-RoPE positions the default arange, as the reference
serves it; the MoE pair, whose decode step routes each token alone); the
encoder-only hubert-xlarge is refused with the reference's reason.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import applicable
from repro_torch.device import resolve_device
from repro_torch.models import model


def build_argparser():
    p = argparse.ArgumentParser(description="greedy serving (PyTorch/CUDA "
                                            "port)")
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--reduced", action="store_true",
                   help="CPU-sized variant of the arch")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=64)
    p.add_argument("--rounds", type=int, default=3,
                   help="request batches to serve")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    return p


def make_prompts(vocab: int, batch: int, length: int, seed: int
                 ) -> np.ndarray:
    """A (batch, length) int32 prompt batch from numpy's generator."""
    return np.random.default_rng(seed).integers(0, vocab, (batch, length),
                                                dtype=np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, on_round=None, params=None, cfg=None):
    """Serve ``--rounds`` batches; ``on_round(rnd, timing, tokens)`` sees
    each round's times (``prefill_ms``, ``decode_ms``, ``ms_per_token``)
    and its generated tokens (B, gen).  ``params`` (a parameter tree on
    the device, e.g. from ``repro_torch.weights``) replaces the seeded
    random weights; ``cfg`` (a ``ModelConfig``, e.g. an arch with its
    depth cut) replaces the one ``--arch`` / ``--reduced`` name.  Returns
    the generated tokens of every round."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 products in full float32, bfloat16 products accumulated
        # in float32 (as XLA's are)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    ok, reason = applicable(cfg, "decode_32k")
    if not ok:
        raise SystemExit(f"{cfg.arch_id}: {reason}")
    cfg = cfg.replace(use_pallas=True)
    if params is None:
        params = model.init(cfg, device=device, seed=args.seed)
    max_len = args.prompt_len + args.gen
    generated = []
    with torch.inference_mode():
        for rnd in range(args.rounds):
            prompts = torch.from_numpy(make_prompts(
                cfg.vocab_size, args.batch, args.prompt_len,
                args.seed + rnd + 1)).to(device)
            _sync(device)
            t0 = time.perf_counter()
            last, cache = model.prefill(params, cfg, {"tokens": prompts},
                                        max_len=max_len)
            _sync(device)
            t_pre = time.perf_counter() - t0

            out = [torch.argmax(last, -1)[:, None]]
            t0 = time.perf_counter()
            for t in range(args.prompt_len, max_len - 1):
                logits, cache = model.decode_step(params, cfg, cache,
                                                  out[-1], t)
                out.append(torch.argmax(logits[:, -1], -1)[:, None])
            gen = torch.cat(out, 1)
            _sync(device)
            t_dec = time.perf_counter() - t0
            n_tok = gen.shape[1] - 1
            timing = dict(prefill_ms=t_pre * 1e3, decode_ms=t_dec * 1e3,
                          ms_per_token=t_dec / max(n_tok, 1) * 1e3)
            generated.append(gen)
            if on_round is not None:
                on_round(rnd, timing, gen)
            print(f"round {rnd}: prefill {args.prompt_len}tok "
                  f"{timing['prefill_ms']:8.1f}ms | decode {n_tok}tok "
                  f"{timing['decode_ms']:8.1f}ms ({timing['ms_per_token']:.2f}"
                  f" ms/tok) | batch {args.batch} on {device}", flush=True)
    return generated


if __name__ == "__main__":
    main()
