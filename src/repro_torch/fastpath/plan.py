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

A tree of 2-byte (bfloat16 or float16) and float32 leaves
(``layout.MixedLayout``) has two buffers a state (``layout.Parts``): every
op launches its kernel once per part, at that part's dtypes
(``kernels.ENTRIES``), builds the ``(W, num_leaves)`` per-leaf partials
of both parts in the tree's leaf order and only then reduces across
leaves, so the sums are the reference's.  Each part's zero tail folds into
that part's first leaf.

:class:`RowShardPlan` runs the same ops on one rank's row shard
(``layout.RowShard``): each kernel on the rank's ``(W, shard_rows, 128)``
operands, its per-sub-block partials gathered across ranks in rank order
into the one-rank ``(W, nsubs)`` partials, then folded in the order above —
so every sum and max is bitwise the one-rank plane's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.fastpath import kernels
from repro_torch.fastpath.layout import (SUPPORTED_DTYPES, FlatLayout,
                                         MixedLayout, like_parts, parts_of)

MODES = ("auto", "on")


class FastPathPlan:
    """Resolved batched-comm-plane configuration for one policy."""

    def __init__(self, mode: str = "auto"):
        if mode not in MODES:
            raise ValueError(f"fastpath mode must be one of {MODES}, got "
                             f"{mode!r}")
        self.mode = mode
        self._sub_leaf: Dict[Tuple, torch.Tensor] = {}
        self._order: Dict[Tuple, torch.Tensor] = {}

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

    def _leaf_order(self, per_part, lo) -> torch.Tensor:
        """Per-part (W, n_p) per-leaf columns → (W, num_leaves) in the
        tree's leaf order (a gather: the values move unchanged)."""
        if not isinstance(lo, MixedLayout):
            return per_part[0]
        dev = per_part[0].device
        key = (lo.leaf_part, str(dev))
        order = self._order.get(key)
        if order is None:
            n_b = lo.parts[0].num_leaves
            order = torch.as_tensor([i + n_b * p for p, i in zip(
                lo.leaf_part, lo.leaf_index)], dtype=torch.long, device=dev)
            self._order[key] = order
        return torch.cat(per_part, dim=1).index_select(1, order)

    def _leaf_sums(self, partials, lo) -> torch.Tensor:
        """Per-part per-sub-block partials → (W,): per (worker, leaf) over
        each part, then across all leaves in the tree's order."""
        per = [self._per_leaf(x, p, "sum")
               for x, p in zip(partials, lo.parts)]
        return torch.sum(self._leaf_order(per, lo), dim=1)

    # -- buffer-level ops (one kernel launch per part each) ------------------

    # -- what a row shard changes (RowShardPlan) ---------------------------

    def _layout(self, lo):
        """The layout the partials are reduced with."""
        return lo

    def _whole(self, partials: torch.Tensor, what: str) -> torch.Tensor:
        """The (W, nsubs) partials of the whole buffer from this call's
        own kernel's: here they are."""
        return partials

    def _step_subs(self, p: FlatLayout, device) -> torch.Tensor:
        """Each of the operands' sub-blocks' leaf (LAQ's per-sub-block
        step)."""
        return self.sub_leaf(p, device)

    def delta_sqnorm(self, a, b, lo) -> torch.Tensor:
        """Per-worker ‖a − b‖² over (W, rows, 128) buffers → (W,) float32.
        ``b`` may be the unstacked (rows, 128) shared buffer."""
        return self._leaf_sums([self._whole(kernels.delta_sqnorm_blocks(
            x, y), "delta_sqnorm") for x, y in zip(parts_of(a),
                                                   parts_of(b))],
            self._layout(lo))

    def sqnorm(self, t: torch.Tensor, lo: FlatLayout) -> torch.Tensor:
        """Per-worker ‖t‖² over a (W, rows, 128) buffer → (W,) float32."""
        return self._total(self._whole(kernels.sqnorm_blocks(t), "sqnorm"),
                           self._layout(lo))

    def laq_encode(self, g, q, e, lo, *, bits: int, payload_out=None):
        """Batched LAQ encode with per-(worker, leaf) quantizer scales.

        Returns (payload (W, rows, 128), residual (W, rows, 128), trigger
        LHS ‖payload‖² (W,), quantizer steps (W, num_leaves) in leaf
        order); payload and residual are float32 (pairs of a mixed tree).
        The scale/qmax division happens once, here: the encode kernel gets
        the already-divided steps.  It is an IEEE division on every device:
        the divisor is a tensor on the scales' own device, because
        PyTorch's CUDA division by a Python scalar (or by a CPU 0-d tensor,
        which it treats as one) multiplies by the reciprocal, which differs
        in the last bit for about half the scales.  ``payload_out`` (may be
        ``g``; of a pair, per part, None where a part takes a new buffer)
        receives the payload in place.
        """
        lo = self._layout(lo)
        pays, resids, sqs, steps = [], [], [], []
        for p, x, y, z, o in zip(lo.parts, parts_of(g), parts_of(q),
                                 parts_of(e), _outs(payload_out, g)):
            scales = self._per_leaf(self._whole(kernels.absmax_blocks(
                x, y, z), "absmax"), p, "max")            # (W, leaves of p)
            st = scales / torch.full_like(scales,
                                          float(2 ** (bits - 1) - 1))
            pay, res, sq = kernels.laq_encode_blocks(
                x, y, z, st[:, self._step_subs(p, x.device)], bits,
                payload_out=o)
            pays.append(pay)
            resids.append(res)
            sqs.append(self._whole(sq, "laq_sq"))
            steps.append(st)
        return (like_parts(g, pays), like_parts(g, resids),
                self._leaf_sums(sqs, lo), self._leaf_order(steps, lo))

    def _masked(self, a, b, mask, mode, out):
        return like_parts(b, [kernels.masked_combine(x, y, mask, mode, out=o)
                              for x, y, o in zip(parts_of(a), parts_of(b),
                                                 _outs(out, b))])

    def masked_add(self, a, b, mask, out=None):
        """b + mask·a per worker (fold a masked payload into a mirror)."""
        return self._masked(a, b, mask, "add", out)

    def masked_select(self, a, b, mask, out=None):
        """where(mask, a, b) per worker — an exact copy on upload."""
        return self._masked(a, b, mask, "select", out)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FastPathPlan(mode={self.mode!r})"


class RowShardPlan(FastPathPlan):
    """The plane on one rank's rows of a ``FlatLayout`` (``layout.
    RowShard``).  The kernels run on the rank's ``(W, shard_rows, 128)``
    buffers; ``gather(partials, what)`` (the trainer's collective) returns
    every rank's ``(W, shard_rows/8)`` partials stacked in rank order; they
    are cut back to the layout's sub-blocks and reduced with the full
    layout, so ‖g − ĝ‖², the trigger's right-hand side and LAQ's absmax are
    bitwise the one-rank plane's.  The ops take the shard's one-leaf layout
    (``RowShard.layout``) as ``lo``, the layout the plain route sees; the
    full layout is the plan's own."""

    def __init__(self, mode: str, full: FlatLayout, shard, gather):
        super().__init__(mode)
        if not isinstance(full, FlatLayout):
            raise TypeError("a row-sharded plane takes a tree of one dtype "
                            "(a FlatLayout), not a MixedLayout's parts")
        self.full, self.shard, self.gather = full, shard, gather
        self._shard_subs: Dict[str, torch.Tensor] = {}

    def supports(self, layout) -> bool:
        return FastPathPlan.supports(self.full)

    def _layout(self, lo):
        if lo.rows != self.shard.shard_rows:
            raise ValueError(f"a row-sharded plane takes the shard's "
                             f"{self.shard.shard_rows} rows, got {lo.rows}")
        return self.full

    def _whole(self, partials: torch.Tensor, what: str) -> torch.Tensor:
        """This rank's (W, shard_rows/8) partials → every rank's, as the
        one-rank (W, rows/8) partials (a contiguous tensor, laid out as
        the one-rank kernel's output is)."""
        g = self.gather(partials, what).to(partials.device)  # (N, W, s)
        whole = g.permute(1, 0, 2).reshape(partials.shape[0], -1)
        return whole[:, :self.full.rows // 8].contiguous()

    def _step_subs(self, p: FlatLayout, device) -> torch.Tensor:
        key = str(device)
        idx = self._shard_subs.get(key)
        if idx is None:
            idx = torch.as_tensor(self.shard.sub_leaf(self.full),
                                  dtype=torch.long, device=device)
            self._shard_subs[key] = idx
        return idx


def _outs(out, like):
    """``out``'s parts, or None for each part of ``like``."""
    return parts_of(out) if out is not None else (None,) * len(parts_of(like))


def make_plan(spec) -> FastPathPlan:
    """'auto'/'on' → a plan; plans pass through."""
    if isinstance(spec, FastPathPlan):
        return spec
    return FastPathPlan(spec)


def active_plan(policy, x) -> Optional[FastPathPlan]:
    """The policy's plan iff it is active for tensors like ``x`` (on CUDA,
    or forced); None for a policy without a plan (the per-leaf kernels
    selected by ``make_policy(use_pallas=True)``)."""
    plan = policy.fastpath
    return plan if plan is not None and plan.enabled_for(parts_of(x)[0]) \
        else None
