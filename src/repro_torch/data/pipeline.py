"""Deterministic synthetic data — port of ``repro.data.pipeline``: LM token
batches and the audio and VLM variants.

The draws are numpy, seeded per (seed, step, worker) exactly as the
reference, so the port's batches equal the reference's bit for bit.  The
batches land on ``device``: the card unless the caller asks for the CPU.
Worker-shard heterogeneity is a dial (``repro_torch.netsim.hetero``);
:func:`make_heterogeneous_inputs` is its wrapper.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.shapes import vision_prefix
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class TokenStream:
    """Structured synthetic tokens: x_{t+1} = (a·x_t + drift_w) mod V with
    per-position noise; workers get different drifts."""
    vocab: int
    seed: int = 0

    def batch(self, step: int, worker: int, batch: int, seq: int,
              noise: float = 0.1) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, worker]))
        a = 6364136223846793005 % self.vocab
        drift = 1 + 97 * worker
        x = rng.integers(0, self.vocab, size=(batch, 1))
        rows = [x]
        for _ in range(seq - 1):
            nxt = (rows[-1] * a + drift) % self.vocab
            noise_toks = rng.integers(0, self.vocab, size=nxt.shape)
            use_noise = rng.random(nxt.shape) < noise
            rows.append(np.where(use_noise, noise_toks, nxt))
        return np.concatenate(rows, axis=1).astype(np.int32)


def make_inputs(cfg: ModelConfig, stream: TokenStream, step: int,
                batch: int, seq: int, worker: int = 0,
                device="cuda") -> dict:
    """One training batch for any family, on ``device`` ("cuda" by
    default, which raises without a GPU): LM {"tokens", "targets"} (B,
    seq) int32; audio {"frames" (B, seq, d) float, "mask" (B, seq) bool,
    "targets"}; VLM {"tokens", "targets"} (B, seq − nv), "vision_embeds"
    (B, nv, d) and "positions3" (3, B, seq) with nv = seq // 4."""
    device = resolve_device(device)
    toks = stream.batch(step, worker, batch, seq + 1)
    tokens, targets = toks[:, :-1], toks[:, 1:]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if cfg.family == "audio":
        rng = np.random.default_rng(
            np.random.SeedSequence([stream.seed, step, worker, 7]))
        frames = rng.standard_normal((batch, seq, cfg.d_model)).astype(
            np.float32)
        mask = rng.random((batch, seq)) < 0.08
        return {"frames": put(frames).to(cfg.compute_dtype),
                "mask": put(mask),
                "targets": put(targets % cfg.vocab_size)}
    if cfg.family == "vlm":
        nv = vision_prefix(cfg, seq)
        rng = np.random.default_rng(
            np.random.SeedSequence([stream.seed, step, worker, 9]))
        ve = rng.standard_normal((batch, nv, cfg.d_model)).astype(
            np.float32) * 0.02
        base = np.broadcast_to(np.arange(seq)[None], (batch, seq))
        return {"tokens": put(tokens[:, :seq - nv]),
                "vision_embeds": put(ve).to(cfg.compute_dtype),
                "positions3": put(np.broadcast_to(
                    base[None], (3, batch, seq)).astype(np.int32)),
                "targets": put(targets[:, :seq - nv])}
    return {"tokens": put(tokens), "targets": put(targets)}


def make_heterogeneous_inputs(cfg: ModelConfig, stream: TokenStream,
                              step: int, num_workers: int, batch: int,
                              seq: int, *, fixed: bool = True,
                              noise_lo: float = 0.01, noise_hi: float = 0.4,
                              h: float = 1.0, device="cuda") -> dict:
    """Global batch whose worker shards have heterogeneous predictability:
    worker m's stream noise sits at dial position ``h`` of the
    noise_lo→noise_hi ramp (:func:`repro_torch.netsim.hetero.
    hetero_inputs`; h = 1 is the full ramp, h = 0 its midpoint for every
    worker).  ``fixed=True`` reuses step 0's data every round."""
    from repro_torch.netsim.hetero import hetero_inputs  # data ↛ netsim
    return hetero_inputs(cfg, stream, step, num_workers, batch, seq, h=h,
                         fixed=fixed, noise_lo=noise_lo, noise_hi=noise_hi,
                         device=device)
