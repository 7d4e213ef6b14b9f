"""Deterministic synthetic token data — port of ``repro.data.pipeline``
(LM batches only).

The stream is numpy, seeded per (seed, step, worker) exactly as the
reference, so the port's batches equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
                device="cpu") -> dict:
    """One LM training batch: {"tokens", "targets"} (B, seq) int32."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} inputs are not "
                                  f"ported yet")
    toks = stream.batch(step, worker, batch, seq + 1)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
            "targets": torch.from_numpy(toks[:, 1:].copy()).to(device)}
