"""Pytree entry points of the legacy per-leaf LAG-trigger kernels — port of
``repro.kernels.lag_trigger.ops``.

Each function visits the leaves in pytree order and launches one kernel
per leaf (two for the LAQ encode), at that leaf's own operand dtypes (a
tree of bfloat16 and float32 leaves launches each leaf's instantiation).
CPU tensors take the plain version (``ref``), and so does
``use_ref=True``; CUDA tensors launch the hand-written kernel of
``lag_trigger`` or raise.  Off ``use_ref`` an operand combination that
``lag_trigger.ENTRIES`` does not build raises ``TypeError`` on the CPU as
on the card.  Per-leaf sums are added in leaf order on the device: nothing
here waits for the device.

This is the trainer's route under ``TrainerConfig(use_pallas_comm=True)``
(``fused_tree_sqnorm`` as the triggers' ``sqnorm_fn``, ``laq_encode`` as
LAQ's encode).  The default route is the batched plane
(``repro_torch.fastpath``): one launch per round for all workers and
leaves, where this route makes one per leaf and per worker.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.kernels import on_cuda
from repro_torch.kernels.lag_trigger import ref
from repro_torch.kernels.lag_trigger.lag_trigger import (
    check_dtypes, delta_sqnorm_2d, innovation_absmax_2d, laq_encode_2d,
    masked_update_2d, sqnorm_2d)

Pytree = Any


def _kernel(name: str, use_ref: bool, *xs: torch.Tensor) -> bool:
    """True where the leaf takes ``name``'s kernel; off ``use_ref`` its
    operand dtypes must be an instantiation's on every device."""
    if use_ref:
        return False
    check_dtypes(name, *xs)
    return on_cuda(xs[0])


def _add_in_order(parts, like) -> torch.Tensor:
    """Σ of 0-d float32 tensors, in order (0 for none)."""
    total = None
    for s in parts:
        total = s if total is None else total + s
    if total is None:
        dev = like[0].device if like else None
        return torch.zeros((), dtype=torch.float32, device=dev)
    return total


def delta_sqnorm(g_new: Pytree, g_old: Pytree, *,
                 use_ref: bool = False) -> torch.Tensor:
    """‖g_new − g_old‖² over a pytree (0-d float32)."""
    a_l, b_l = tree_leaves(g_new), tree_leaves(g_old)
    return _add_in_order(
        (delta_sqnorm_2d(a.contiguous(), b.contiguous())
         if _kernel("delta_sqnorm_2d", use_ref, a, b)
         else ref.delta_sqnorm(a, b)
         for a, b in zip(a_l, b_l)), a_l)


def masked_lazy_update(g_new: Pytree, g_old: Pytree, mask, *,
                       use_ref: bool = False) -> Pytree:
    """g_hat ← g_old + mask·(g_new − g_old) over a pytree (leaves in
    ``g_old``'s dtypes); ``mask`` is one bool/float value."""
    def upd(a, b):
        if _kernel("masked_update_2d", use_ref, a, b):
            return masked_update_2d(a.contiguous(), b.contiguous(),
                                    torch.as_tensor(mask, device=b.device))
        return ref.masked_lazy_update(a, b, mask)

    return tree_map(upd, g_new, g_old)


def fused_tree_sqnorm(tree: Pytree, *, use_ref: bool = False
                      ) -> torch.Tensor:
    """Σ ‖leaf‖² over a pytree (0-d float32) — drop-in for
    ``repro_torch.core.lag.tree_sqnorm`` through the trigger rules'
    ``sqnorm_fn`` injection point."""
    leaves = tree_leaves(tree)
    return _add_in_order(
        (sqnorm_2d(l.contiguous()) if _kernel("sqnorm_2d", use_ref, l)
         else ref.sqnorm(l) for l in leaves), leaves)


def laq_encode(g_new: Pytree, q_hat: Pytree, resid: Pytree, *,
               bits: int = 4, use_ref: bool = False,
               return_steps: bool = False):
    """LAQ candidate upload over a pytree: per-leaf b-bit quantization of
    the error-compensated innovation v = (∇ − q̂) + e.

    Returns (payload tree, residual tree, ‖payload‖² summed over leaves),
    float32.  The kernel route is one absmax sweep and one fused
    quantize/residual/‖p‖² sweep per leaf.  ``return_steps`` appends the
    per-leaf quantizer steps scale/qmax as a ``(num_leaves,)`` float32
    tensor (pytree order): the same IEEE division of the same float32
    scale the encode made, so payload coordinates are exactly code·step.
    """
    g_leaves, tdef = tree_flatten(g_new)
    ps, es, steps = [], [], []
    lhs = torch.zeros((), dtype=torch.float32,
                      device=g_leaves[0].device if g_leaves else None)
    for g, q, e in zip(g_leaves, tree_leaves(q_hat), tree_leaves(resid)):
        if _kernel("laq_encode_2d", use_ref, g, q, e):
            g, q, e = g.contiguous(), q.contiguous(), e.contiguous()
            scale = innovation_absmax_2d(g, q, e)
            p, enew, sq = laq_encode_2d(g, q, e, scale, bits)
        else:
            scale = ref.innovation_absmax(g, q, e)
            p, enew, sq = ref.laq_encode(g, q, e, scale, bits)
        ps.append(p)
        es.append(enew)
        steps.append(ref.quantizer_step(scale, bits))
        lhs = lhs + sq
    out = (tree_unflatten(tdef, ps), tree_unflatten(tdef, es), lhs)
    if return_steps:
        return out + (torch.stack(steps) if steps else torch.zeros((0,)),)
    return out
