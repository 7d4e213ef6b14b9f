"""Pod-level LAG: the cross-pod reduction is skipped on quiet rounds —
port of ``repro.dist.pod_lag``.

A thin shim over the engine: the lazy units are whole pods, and the
topology (``repro_torch.engine.topology.PodMesh``) sums the pods' masked
deltas only when some pod uploads; a quiet round's deltas are all exactly
zero, so the trajectory is bitwise the unconditional sum's.  The step is
the trainer's ``make_train_step`` and its round ``engine.rounds.
lag_round``.  The state is the trainer's with the worker dim sized
``n_pods`` plus a ``rounds_skipped`` counter.  The port has no device mesh
yet (``launch/mesh.py``), so nothing is pinned to a pod axis.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.dist import lag_trainer
from repro_torch.dist.lag_trainer import TrainerConfig
from repro_torch.engine.topology import PodMesh
from repro_torch.models.common import ModelConfig


def init_state(cfg: ModelConfig, tcfg: TrainerConfig, n_pods: int, *,
               device, seed: int = 0, params=None) -> Dict:
    """Trainer state with one lazy-aggregation unit per pod."""
    return lag_trainer.init_state(
        cfg, tcfg.replace(num_workers=n_pods), device=device, seed=seed,
        params=params, topology=PodMesh(num_units=n_pods))


def make_pod_lag_step(cfg: ModelConfig, tcfg: TrainerConfig, policy=None,
                      topology=None):
    """Build ``(state, batch) → (state, metrics)``; the number of pods is
    read off the state's worker dim.  ``topology`` (a ``PodMesh``) may be
    passed to read its ``branches`` counter."""
    return lag_trainer.make_train_step(
        cfg, tcfg, policy=policy,
        topology=topology if topology is not None else PodMesh())
