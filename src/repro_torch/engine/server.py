"""Server-side optimizers — port of ``repro.engine.server``: what the
parameter server does with the lazily aggregated gradient ∇^k.

  sgd        θ^{k+1} = θ^k − α·∇^k — the paper's eq. (4)
  momentum   heavy ball on the mean aggregate
  adam       Adam on the mean aggregate (known trigger pathology with a
             LAG trigger: the reference's EXPERIMENTS.md)
  prox-l1    eq. (4), then soft-thresholding prox_{α·λ‖·‖₁}

``apply`` receives the SUM aggregate ∇^k = Σ_m ĝ_m and the trigger
constants (``cfg.alpha`` is α = lr/M, the α the trigger RHS reads);
momentum and Adam consume the MEAN aggregate with lr = α·M.  The trainer
hands every server the flat ``(rows, 128)`` buffers of the parameter
layout (one-leaf trees: the math is elementwise, and the zero padding stays
zero under every step), so momentum's ``m`` and Adam's ``mu``/``nu`` are
flat float32 buffers too, updated in place.  ``init`` returns None for a
stateless server.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim import optimizers

Pytree = Any


class ServerOptimizer:
    """Protocol: ``init(params) → state`` / ``apply(params, state, nabla,
    step, cfg) → (new_params, new_state)``.  ``composite_loss`` declares
    the objective the server minimizes (prox-l1: L(θ) + λ‖θ‖₁)."""
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
    """The paper's eq. (4): θ^{k+1} = θ^k − α·∇^k (the product rounded
    first, never one fused multiply-add, as the reference computes it)."""
    name = "sgd"

    def apply(self, params, opt_state, nabla, step, cfg):
        new_params = tree_map(
            lambda t, g: optimizers.sub_scaled(t, cfg.alpha, g), params,
            nabla)
        return new_params, opt_state


class MomentumServer(ServerOptimizer):
    """Heavy-ball SGD on the mean aggregate (lr = α·M)."""
    name = "momentum"

    def __init__(self, momentum: float = 0.9):
        if not 0.0 < momentum < 1.0:
            raise ValueError(f"momentum must be in (0, 1), got {momentum}")
        self.momentum = momentum

    def init(self, params):
        return tree_map(torch.zeros_like, params)

    def apply(self, params, opt_state, nabla, step, cfg):
        M = cfg.num_workers
        opt = optimizers.sgd(cfg.alpha * M, self.momentum)
        mean = lag.tree_scale(nabla, 1.0 / M)
        return opt.update(mean, opt_state, params, step)


class AdamServer(ServerOptimizer):
    """Adam on the mean aggregate (lr = α·M); with a LAG trigger it
    inherits the reference's documented α-coupling pathology."""
    name = "adam"

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return optimizers.adam(1.0, b1=self.b1, b2=self.b2).init(params)

    def apply(self, params, opt_state, nabla, step, cfg):
        M = cfg.num_workers
        opt = optimizers.adam(cfg.alpha * M, b1=self.b1, b2=self.b2,
                              eps=self.eps)
        mean = lag.tree_scale(nabla, 1.0 / M)
        return opt.update(mean, opt_state, params, step)


class ProxL1Server(ServerOptimizer):
    """Proximal LAG: eq. (4), then soft-thresholding at α·λ.  The reported
    objective is the composite L(θ) + λ‖θ‖₁; the round pushes the
    iterate-lag history from the post-prox movement."""
    name = "prox-l1"

    def __init__(self, l1: float = 1e-3):
        if l1 <= 0.0:
            raise ValueError(f"prox-l1 strength must be positive, got {l1}")
        self.l1 = l1

    def apply(self, params, opt_state, nabla, step, cfg):
        stepped = tree_map(
            lambda t, g: optimizers.sub_scaled(t, cfg.alpha, g), params,
            nabla)
        thr = cfg.alpha * self.l1

        def shrink(t):
            # sign(t)·max(|t| − thr, 0), in the stepped buffer itself
            s = torch.sign(t)
            return t.abs_().sub_(lag.weak(thr, t.dtype)).clamp_(
                min=0.0).mul_(s)

        return tree_map(shrink, stepped), opt_state

    def composite_loss(self, loss, params):
        return loss + self.l1 * sum(torch.sum(torch.abs(l))
                                    for l in tree_leaves(params))


# ---------------------------------------------------------------------------
# Registry + spec parsing
# ---------------------------------------------------------------------------

SERVERS = {
    "sgd": SGDServer,
    "momentum": MomentumServer,
    "adam": AdamServer,
    "prox-l1": ProxL1Server,
}


def make_server(spec, **kw) -> ServerOptimizer:
    """Build a ``ServerOptimizer`` from a spec string (or pass one through).

    Grammar: ``<name>[@<param>]`` where the optional float parameter is
    the momentum coefficient (``"momentum@0.9"``) or the l1 strength
    (``"prox-l1@5.0"``); ``sgd``/``adam`` take none.  Extra ``kw`` reach
    the constructor (``make_server("adam", b1=0.8)``).
    """
    if isinstance(spec, ServerOptimizer):
        return spec
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"server spec must be a non-empty string or a "
                         f"ServerOptimizer, got {spec!r}")
    name, sep, param = spec.partition("@")
    name = name.strip()
    if name not in SERVERS:
        raise ValueError(f"unknown server optimizer {spec!r}; known: "
                         f"{tuple(SERVERS)} (optionally '@<float>' for "
                         f"momentum / prox-l1)")
    cls = SERVERS[name]
    if sep:
        try:
            value = float(param)
        except ValueError:
            raise ValueError(
                f"bad server spec {spec!r}: '@{param}' is not a float "
                f"(want e.g. 'momentum@0.9' or 'prox-l1@5.0')") from None
        if cls is MomentumServer:
            kw.setdefault("momentum", value)
        elif cls is ProxL1Server:
            kw.setdefault("l1", value)
        else:
            raise ValueError(
                f"bad server spec {spec!r}: {name!r} takes no '@' "
                f"parameter (only momentum / prox-l1 do)")
    return cls(**kw)
