"""Server-side optimizers — port of ``repro.engine.server`` (SGD only for
now; momentum, Adam and prox-l1 are not ported yet).

``apply`` receives the SUM aggregate ∇^k = Σ_m ĝ_m and the trigger
constants (``cfg.alpha`` is α = lr/M, the α the trigger RHS reads).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core import lag
from repro_torch.core.tree import tree_map

Pytree = Any


class ServerOptimizer:
    """Protocol: ``init(params) → state`` / ``apply(params, state, nabla,
    step, cfg) → (new_params, new_state)``."""
    name: str = "server"

    def init(self, params: Pytree) -> Optional[Pytree]:
        return None

    def apply(self, params: Pytree, opt_state: Optional[Pytree],
              nabla: Pytree, step, cfg: lag.LAGConfig
              ) -> Tuple[Pytree, Optional[Pytree]]:
        raise NotImplementedError

    def composite_loss(self, loss: torch.Tensor, params: Pytree
                       ) -> torch.Tensor:
        return loss

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(name={self.name!r})"


class SGDServer(ServerOptimizer):
    """The paper's eq. (4): θ^{k+1} = θ^k − α·∇^k (two ops, never fused
    into one multiply-add, as the reference computes it)."""
    name = "sgd"

    def apply(self, params, opt_state, nabla, step, cfg):
        new_params = tree_map(lambda t, g: t - cfg.alpha * g, params, nabla)
        return new_params, opt_state


SERVERS = {"sgd": SGDServer}


def make_server(spec) -> ServerOptimizer:
    """``"sgd"`` → ``SGDServer()``; optimizers pass through."""
    if isinstance(spec, ServerOptimizer):
        return spec
    if spec not in SERVERS:
        raise ValueError(f"unknown server optimizer {spec!r}; the port has: "
                         f"{tuple(SERVERS)}")
    return SERVERS[spec]()
