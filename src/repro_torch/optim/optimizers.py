"""Optimizers — port of ``repro.optim.optimizers``: SGD (+momentum),
Adam/AdamW, global-norm clipping and LR schedules, as plain functions on
trees of tensors (``repro_torch.core.tree``; one flat buffer is a one-leaf
tree).

An :class:`Optimizer` is ``(init, update)`` with ``update(grads, state,
params, step) → (new_params, new_state)``.  The new parameters are new
tensors (the caller measures the movement against the old ones); the state
tensors are updated IN PLACE and returned, because the in-place sequence is
the reference's arithmetic operation for operation: ``b·m + g`` is one
rounded product and one rounded add, never a fused multiply-add (so no
``add_(x, alpha=…)``, which PyTorch computes as one).

The scalars follow the reference's float32 ``jnp`` scalars: the stepsize
``a``, and Adam's ``t = step + 1`` and bias corrections ``1 − β^t`` are
float32 tensors computed on the host (float32 ``pow`` there agrees with
XLA's), then moved to the parameters' device.  A CUDA division by a CPU
0-d tensor would be a multiply by its reciprocal, which differs from the
IEEE quotient in the last bit; a divisor on the device divides.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import lag
from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)

Pytree = Any


class Optimizer(NamedTuple):
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree, Any], tuple]
    # update(grads, opt_state, params, step) -> (new_params, new_state)


def _f32(x) -> torch.Tensor:
    """A float32 host scalar (a 0-d tensor passes through, on the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.tensor(x, dtype=torch.float32)


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 sqrt, in place, as XLA's and CUDA's.
    PyTorch's float32 sqrt on the CPU is not (it is one ulp off for about
    0.7 % of values), so CPU tensors go through float64, whose sqrt rounds
    to the right float32."""
    if x.is_cuda:
        return x.sqrt_()
    return x.copy_(torch.sqrt(x.double()))


def sub_scaled(p: torch.Tensor, a, x: torch.Tensor) -> torch.Tensor:
    """p − a·x with the product rounded first, as the reference computes
    it, into ONE new buffer (the difference overwrites the product): at
    full width a second parameter-sized temporary would raise the peak.

    The product's precision is the reference's: a Python ``a`` is weakly
    typed (rounded to x's dtype: ``t − α·g`` on bfloat16 leaves rounds α
    to bfloat16), a tensor ``a`` promotes (a float32 stepsize times a
    bfloat16 ``x`` is a float32 product), and the product is rounded once
    to p's dtype before the difference."""
    if isinstance(a, torch.Tensor):
        ct = torch.promote_types(a.dtype, x.dtype)
        d = x.to(ct) * a
    else:
        d = x * lag.weak(a, x.dtype)
    if d.dtype != p.dtype:
        d = d.to(p.dtype)
    return torch.sub(p, d, out=d)


def _on(x: torch.Tensor, tree: Pytree) -> torch.Tensor:
    """Move a 0-d scalar to the device of ``tree``'s leaves."""
    leaves = tree_leaves(tree)
    return x.to(leaves[0].device) if leaves else x


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


# ---------------------------------------------------------------------------
# Transformations
# ---------------------------------------------------------------------------

def clip_by_global_norm(grads: Pytree, max_norm: float) -> Pytree:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``."""
    leaves = tree_leaves(grads)
    total = None
    for l in leaves:
        s = torch.sum(torch.square(l.float()))
        total = s if total is None else total + s
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    """θ ← θ − a·g, or heavy ball: m ← μ·m + g, then θ ← θ − a·m."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, step):
        a = _on(_f32(sched(step)), params)
        if momentum == 0.0:
            new_params = tree_map(lambda p, g: sub_scaled(p, a, g),
                                  params, grads)
            return new_params, state
        new_state = tree_map(
            lambda m, g: m.mul_(lag.weak(momentum, m.dtype)).add_(g), state,
            grads)
        new_params = tree_map(lambda p, m: sub_scaled(p, a, m), params,
                              new_state)
        return new_params, new_state

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam (AdamW with ``weight_decay``): float32 moments ``mu``/``nu``,
    θ ← θ − a·((mu/bc1) / (sqrt(nu/bc2) + eps) [+ wd·θ])."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads, state, params, step):
        t = _f32(step) + 1.0
        a, bc1, bc2 = (_on(x, params) for x in (
            _f32(sched(step)), 1.0 - b1 ** t, 1.0 - b2 ** t))

        def upd(p, g, mu, nu):
            g32 = g.float()
            mu.mul_(b1).add_((1 - b1) * g32)
            nu.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
            delta = (mu / bc1).div_(_sqrt_(nu / bc2).add_(eps))
            if weight_decay:
                delta = delta + weight_decay * p.float()
            delta.mul_(a)
            # θ in float32 first, as the reference: a float64 θ (the x64
            # convex runs) is rounded before the step, not after it
            return torch.sub(p.float(), delta, out=delta).to(p.dtype)

        flat_p, tdef = tree_flatten(params)
        new = [upd(p, g, mu, nu) for p, g, mu, nu in zip(
            flat_p, tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]))]
        return tree_unflatten(tdef, new), state

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)
