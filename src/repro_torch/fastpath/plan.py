"""``FastPathPlan`` — the batched comm plane, resolved once per policy —
port of ``repro.fastpath.plan``.

A plan owns the activation decision (``"auto"`` → on when the tensors are
on CUDA; ``"on"`` forces the plane, which runs the plain kernel versions on
CPU tensors — what the parity tests do), and the buffer-level ops: each one
kernel launch over ``(workers, rows)`` plus a deterministic fixed-order
reduction from per-sub-block partials to per-(worker, leaf) scalars.

Unlike the reference, the port's plan takes the layout's flat buffers
directly: the trainer keeps per-worker state natively as ``(W, rows, 128)``
float32 buffers (a stacked tree would be flattened and unflattened every
call, several W × 4.9 GB copies at full width).

Reduction-order contract (the reference's): partials are reduced per
(worker, leaf) over the leaf's contiguous sub-block range, then across
leaves in leaf order — the same inputs give bit-identical results on every
call.  No ``index_add_``/``scatter_add_``: they are atomic on CUDA.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.fastpath import kernels
from repro_torch.fastpath.layout import SUPPORTED_DTYPES, FlatLayout

MODES = ("auto", "on")


class FastPathPlan:
    """Resolved batched-comm-plane configuration for one policy."""

    def __init__(self, mode: str = "auto"):
        if mode not in MODES:
            raise ValueError(f"fastpath mode must be one of {MODES}, got "
                             f"{mode!r}")
        self.mode = mode
        self._sub_leaf: Dict[Tuple, torch.Tensor] = {}

    def enabled_for(self, x: torch.Tensor) -> bool:
        """Auto plans activate for CUDA tensors; forced plans always."""
        return self.mode == "on" or x.is_cuda

    @staticmethod
    def supports(layout: FlatLayout) -> bool:
        """True iff every leaf dtype is one the f32 plane can serve."""
        return all(d in SUPPORTED_DTYPES for d in layout.dtypes)

    def sub_leaf(self, lo: FlatLayout, device) -> torch.Tensor:
        key = (lo.leaf_subs, lo.nblocks, str(device))
        t = self._sub_leaf.get(key)
        if t is None:
            t = torch.as_tensor(lo.sub_leaf, dtype=torch.long, device=device)
            self._sub_leaf[key] = t
        return t

    # -- reductions: per-sub-block partials → per-leaf → scalar -------------

    @staticmethod
    def _per_leaf(partials: torch.Tensor, lo: FlatLayout,
                  op: str) -> torch.Tensor:
        """(W, nsubs) partials → (W, num_leaves), each leaf reduced over its
        contiguous sub-block range.  Tail sub-blocks (zeros, mapped to leaf
        0) are folded into leaf 0, as the reference's segment reduction
        does; an empty leaf reduces to the identity (0 / −inf)."""
        W = partials.shape[0]
        red = torch.sum if op == "sum" else torch.amax
        ident = 0.0 if op == "sum" else float("-inf")
        tail = partials[:, lo.nsubs:]
        cols = []
        for i in range(lo.num_leaves):
            off, n = lo.leaf_sub_offsets[i], lo.leaf_subs[i]
            seg = partials[:, off:off + n]
            if i == 0 and tail.shape[1]:
                seg = torch.cat([seg, tail], dim=1)
            if seg.shape[1] == 0:
                cols.append(torch.full((W,), ident, dtype=partials.dtype,
                                       device=partials.device))
            else:
                cols.append(red(seg, dim=1))
        if not cols:
            return partials.new_zeros((W, 0))
        return torch.stack(cols, dim=1)

    def _total(self, partials: torch.Tensor, lo: FlatLayout) -> torch.Tensor:
        # per-(worker, leaf) partial sums first, leaves last
        return torch.sum(self._per_leaf(partials, lo, "sum"), dim=1)

    # -- buffer-level ops (one kernel launch each) ---------------------------

    def delta_sqnorm(self, a: torch.Tensor, b: torch.Tensor,
                     lo: FlatLayout) -> torch.Tensor:
        """Per-worker ‖a − b‖² over (W, rows, 128) buffers → (W,) float32.
        ``b`` may be the unstacked (rows, 128) shared buffer."""
        parts = kernels.delta_sqnorm_blocks(a, b)
        return self._total(parts, lo)

    def sqnorm(self, t: torch.Tensor, lo: FlatLayout) -> torch.Tensor:
        """Per-worker ‖t‖² over a (W, rows, 128) buffer → (W,) float32."""
        return self._total(kernels.sqnorm_blocks(t), lo)

    def laq_encode(self, g: torch.Tensor, q: torch.Tensor, e: torch.Tensor,
                   lo: FlatLayout, *, bits: int,
                   payload_out: Optional[torch.Tensor] = None):
        """Batched LAQ encode with per-(worker, leaf) quantizer scales.

        Returns (payload (W, rows, 128), residual (W, rows, 128), trigger
        LHS ‖payload‖² (W,), quantizer steps (W, num_leaves)).  The
        scale/qmax division happens once, here: the encode kernel gets the
        already-divided steps.  It is an IEEE division on every device: the
        divisor is a tensor on the scales' own device, because PyTorch's
        CUDA division by a Python scalar (or by a CPU 0-d tensor, which it
        treats as one) multiplies by the reciprocal, which differs in the
        last bit for about half the scales.  ``payload_out`` (may be
        ``g``) receives the payload in place.
        """
        parts = kernels.absmax_blocks(g, q, e)
        scales = self._per_leaf(parts, lo, "max")          # (W, num_leaves)
        steps = scales / torch.full_like(scales, float(2 ** (bits - 1) - 1))
        steps_subs = steps[:, self.sub_leaf(lo, g.device)]
        payload, resid, sq = kernels.laq_encode_blocks(
            g, q, e, steps_subs, bits, payload_out=payload_out)
        return payload, resid, self._total(sq, lo), steps

    def masked_add(self, a, b, mask, out=None):
        """b + mask·a per worker (fold a masked payload into a mirror)."""
        return kernels.masked_combine(a, b, mask, "add", out=out)

    def masked_select(self, a, b, mask, out=None):
        """where(mask, a, b) per worker — an exact copy on upload."""
        return kernels.masked_combine(a, b, mask, "select", out=out)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FastPathPlan(mode={self.mode!r})"


def make_plan(spec) -> FastPathPlan:
    """'auto'/'on' → a plan; plans pass through."""
    if isinstance(spec, FastPathPlan):
        return spec
    return FastPathPlan(spec)


def active_plan(policy, x: torch.Tensor) -> Optional[FastPathPlan]:
    """The policy's plan iff it is active for tensors like ``x`` (on CUDA,
    or forced); None for a policy without a plan (the per-leaf kernels
    selected by ``make_policy(use_pallas=True)``)."""
    plan = policy.fastpath
    return plan if plan is not None and plan.enabled_for(x) else None
