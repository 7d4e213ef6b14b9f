"""Core LAG primitives (Chen et al., NIPS 2018) — port of ``repro.core.lag``.

``LAGConfig``, the pytree helpers, the iterate-lag ring buffer (eq. 14),
the trigger right-hand side of (15a)/(15b) and the two trigger rules.
Trees are nested dicts/lists of tensors flattened in JAX's order
(``repro_torch.core.tree``).  The trigger quantities (history, ξ, RHS) are
float32; squared norms accumulate in ``promote_types(dtype, float32)``, so
float64 leaves (the x64 convex runs) keep float64.  Everything is
functional: new tensors out, inputs untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.tree import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class LAGConfig:
    """Hyper-parameters of LAG (paper notation in brackets): workers [M],
    stepsize [α], iterate-lag window [D], trigger weight [ξ], rule "wk"
    (15a) or "ps" (15b), and the trigger-RHS floor (0.0 = the exact paper
    trigger)."""
    num_workers: int
    alpha: float
    D: int = 10
    xi: float = 0.1
    rule: str = "wk"
    rhs_floor: float = 0.0

    def xi_vector(self, device=None) -> torch.Tensor:
        return torch.full((self.D,), self.xi, dtype=torch.float32,
                          device=device)


# ---------------------------------------------------------------------------
# Pytree helpers
# ---------------------------------------------------------------------------

def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a leaf: at least float32, float64 kept."""
    return torch.promote_types(dtype, torch.float32)


def tree_sqnorm(tree: Pytree) -> torch.Tensor:
    """Σ ‖leaf‖² over the tree, per-leaf sums added in leaf order, each
    in ``promote_types(leaf dtype, float32)``."""
    total = None
    for leaf in tree_leaves(tree):
        x = leaf.to(acc_dtype(leaf.dtype))
        s = torch.sum(x * x)
        total = s if total is None else total + s
    return total if total is not None else torch.zeros((), dtype=torch.float32)


def tree_sqdist(a: Pytree, b: Pytree) -> torch.Tensor:
    """``tree_sqnorm(tree_sub(a, b))`` without holding the difference tree:
    one leaf's difference is alive at a time (accumulated as in
    :func:`tree_sqnorm`)."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        acc = acc_dtype(torch.promote_types(x.dtype, y.dtype))
        d = x.to(acc) - y.to(acc)
        s = torch.sum(d * d)
        total = s if total is None else total + s
    return total if total is not None else torch.zeros((), dtype=torch.float32)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(lambda x, y: x - y, a, b)


def weak(s: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX's weakly typed scalar meets an array of
    ``dtype``: rounded to that dtype first (to bfloat16 for a bfloat16
    leaf; PyTorch would multiply by it in float32).  Unchanged for a
    leaf of 32 or more bits, whose arithmetic rounds it the same way."""
    if dtype.itemsize >= 4:
        return s
    return float(torch.tensor(s, dtype=dtype))


def tree_scale(a: Pytree, s) -> Pytree:
    """Each leaf times ``s``; a Python scalar is :func:`weak`."""
    if isinstance(s, torch.Tensor):
        return tree_map(lambda x: x * s, a)
    return tree_map(lambda x: x * weak(s, x.dtype), a)


def tree_select(pred: torch.Tensor, on_true: Pytree, on_false: Pytree
                ) -> Pytree:
    """Per-tree select on a scalar bool predicate: an exact copy."""
    return tree_map(lambda t, f: torch.where(pred, t.to(f.dtype), f),
                    on_true, on_false)


# ---------------------------------------------------------------------------
# Iterate-lag history (the RHS of the triggers, eq. 14)
# ---------------------------------------------------------------------------

def hist_init(D: int, device=None) -> torch.Tensor:
    """Ring buffer of ‖θ^{k+1-d} − θ^{k-d}‖², most recent first; zeros ⇒
    round 0 triggers every worker (the paper's all-upload init)."""
    return torch.zeros((D,), dtype=torch.float32, device=device)


def hist_push(hist: torch.Tensor, sqnorm_new: torch.Tensor) -> torch.Tensor:
    """Push the newest squared iterate difference to the front."""
    return torch.cat([sqnorm_new.reshape(1).to(torch.float32), hist[:-1]])


def _raw_rhs(hist: torch.Tensor, cfg: LAGConfig) -> torch.Tensor:
    xi = cfg.xi_vector(hist.device)
    return torch.dot(xi, hist) / (cfg.alpha ** 2 * cfg.num_workers ** 2)


def trigger_rhs(hist: torch.Tensor, cfg: LAGConfig) -> torch.Tensor:
    """RHS of (15a)/(15b): (1/(α² M²)) Σ_d ξ_d ‖θ^{k+1-d} − θ^{k-d}‖²,
    floored at ``cfg.rhs_floor`` (0.0 ⇒ the exact paper trigger)."""
    raw = _raw_rhs(hist, cfg)
    if cfg.rhs_floor:
        return torch.clamp(raw, min=float(cfg.rhs_floor))
    return raw


def rhs_underflow(hist: torch.Tensor, cfg: LAGConfig, step) -> torch.Tensor:
    """() bool — the un-floored RHS is exactly 0 after the warm-up round."""
    return (_raw_rhs(hist, cfg) == 0.0) & (torch.as_tensor(step) > 0)


# ---------------------------------------------------------------------------
# Trigger rules (eq. 15): True ⇒ the worker communicates
# ---------------------------------------------------------------------------

def wk_communicate(grad_new: Pytree, grad_hat: Pytree, hist: torch.Tensor,
                   cfg: LAGConfig, *, sqnorm_fn=tree_sqnorm) -> torch.Tensor:
    """LAG-WK (15a): communicate iff ‖∇L_m(θ̂) − ∇L_m(θ^k)‖² > RHS.
    ``sqnorm_fn`` is injectable (the per-leaf kernels' fused norm)."""
    lhs = sqnorm_fn(tree_sub(grad_new, grad_hat))
    return lhs > trigger_rhs(hist, cfg)


def ps_communicate(theta: Pytree, theta_hat: Pytree, L_m: torch.Tensor,
                   hist: torch.Tensor, cfg: LAGConfig,
                   *, sqnorm_fn=tree_sqnorm) -> torch.Tensor:
    """LAG-PS (15b): communicate iff L_m² ‖θ̂_m − θ^k‖² > RHS."""
    lhs = (L_m.to(torch.float32) ** 2) * sqnorm_fn(tree_sub(theta,
                                                            theta_hat))
    return lhs > trigger_rhs(hist, cfg)
