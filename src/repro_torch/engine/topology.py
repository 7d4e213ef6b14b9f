"""Batch placement for the deep trainer — port of the ``split_batch`` /
``BatchShards`` part of ``repro.engine.topology``.
"""
from __future__ import annotations

from typing import Dict

import torch


def split_batch(batch: Dict[str, torch.Tensor], num_workers: int) -> Dict:
    """Reshape every leaf's batch dim into a leading worker dim:
    ``(B, …) → (W, B/W, …)`` — worker m gets rows ``m·B/W:(m+1)·B/W``."""
    W = num_workers
    out = {}
    for key, x in batch.items():
        B = x.shape[0]
        if B % W:
            raise ValueError(f"batch dim {B} not divisible by {W} workers"
                             f" at {key!r}")
        out[key] = x.reshape((W, B // W) + tuple(x.shape[1:]))
    return out


class BatchShards:
    """Batch-shard workers reduced by plain sum — the flat trainer."""
    name = "shards"

    def place_batch(self, batch: Dict, num_units: int) -> Dict:
        return split_batch(batch, num_units)
