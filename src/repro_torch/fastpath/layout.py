"""Static flat-buffer layout: ONE padded ``(rows, 128)`` view of a pytree —
port of ``repro.fastpath.layout``.

Each leaf is flattened, cast to the buffer's dtype (:func:`buffer_dtype`:
float64 for a tree with a float64 leaf, bfloat16 for a tree of bfloat16
leaves only, else float32) and padded up to whole sub-blocks (``SUB_ROWS``
× ``LANES`` = 1024 elements), so a sub-block never straddles two leaves
and per-leaf quantities (LAQ's quantizer scale, the fixed-order
per-(worker, leaf) partial sums) survive batching.  The buffer tail is
padded to whole ``BLOCK_ROWS`` blocks; ``sub_leaf`` maps every sub-block to
its leaf (tail sub-blocks map to leaf 0 — they are all-zero, absorbing for
every plane op).  The constants are the reference's: ``rows``, ``sub_leaf``
and LAQ's per-leaf grid depend on them.

The port keeps per-worker state natively in these buffers.  ``unflatten``
returns VIEWS (no copy) for leaves of the buffer's own dtype, so a tree of
model parameters or mirror state can live inside one flat buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten

Pytree = Any

LANES = 128
SUB_ROWS = 8                    # (8, 128) f32 tile — the leaf-padding unit
SUB = SUB_ROWS * LANES          # 1024 elements per sub-block
BLOCK_ROWS = 256                # buffer-tail padding unit (rows)
SUBS_PER_BLOCK = BLOCK_ROWS // SUB_ROWS
BLOCK = BLOCK_ROWS * LANES

#: leaf dtypes the flat plane serves; everything is computed in float32
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def buffer_dtype(dtypes) -> torch.dtype:
    """The flat buffers' dtype for leaves of ``dtypes``: float64 when one
    of them is float64 (the x64 convex runs, which the plane refuses), so
    that flattening rounds nothing; bfloat16 when every leaf is bfloat16
    (a bfloat16 model: its leaves stay views of a bfloat16 buffer, half
    the bytes); float32 otherwise.  A tree that mixes bfloat16 and float32
    leaves gets float32 here (:func:`mixed_leaves`); the trainer refuses
    to train it."""
    dts = tuple(dtypes)
    if torch.float64 in dts:
        return torch.float64
    if dts and all(d == torch.bfloat16 for d in dts):
        return torch.bfloat16
    return torch.float32


def mixed_leaves(dtypes) -> bool:
    """True for a tree that mixes bfloat16 leaves with leaves of another
    dtype: a bfloat16 config that keeps float32 leaves (the MoE router,
    mamba2's ``A_log``/``dt_bias``/``D``, RG-LRU's ``b_a``/``b_i``)."""
    dts = set(dtypes)
    return torch.bfloat16 in dts and len(dts) > 1


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """The static offset table for one pytree structure (unstacked)."""
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    leaf_subs: Tuple[int, ...]         # sub-blocks per leaf (0 when empty)
    leaf_sub_offsets: Tuple[int, ...]
    nsubs: int                         # data sub-blocks (pre tail pad)
    nblocks: int                       # BLOCK_ROWS blocks (tail padded)
    sub_leaf: np.ndarray               # (nblocks·SUBS_PER_BLOCK,) int32

    @property
    def dtype(self) -> torch.dtype:
        """The flat buffers' dtype (:func:`buffer_dtype` of the leaves)."""
        return buffer_dtype(self.dtypes)

    @property
    def rows(self) -> int:
        return self.nblocks * BLOCK_ROWS

    @property
    def num_leaves(self) -> int:
        return len(self.shapes)

    @classmethod
    def for_tree(cls, tree: Pytree) -> "FlatLayout":
        """Build the layout from an (unstacked) template tree of tensors."""
        leaves, treedef = tree_flatten(tree)
        shapes = tuple(tuple(int(d) for d in l.shape) for l in leaves)
        dtypes = tuple(l.dtype for l in leaves)
        sizes = tuple(int(np.prod(s, dtype=np.int64)) for s in shapes)
        subs = tuple(-(-s // SUB) for s in sizes)       # ceil; 0 stays 0
        offsets, acc = [], 0
        for b in subs:
            offsets.append(acc)
            acc += b
        nblocks = -(-acc // SUBS_PER_BLOCK)
        sub_leaf = np.zeros((nblocks * SUBS_PER_BLOCK,), np.int32)
        sub_leaf[:acc] = np.repeat(np.arange(len(leaves), dtype=np.int32),
                                   np.asarray(subs, np.int64))
        return cls(treedef=treedef, shapes=shapes, dtypes=dtypes,
                   sizes=sizes, leaf_subs=subs,
                   leaf_sub_offsets=tuple(offsets), nsubs=acc,
                   nblocks=nblocks, sub_leaf=sub_leaf)

    # -- flatten ------------------------------------------------------------

    def _check(self, leaves):
        if len(leaves) != self.num_leaves:
            raise ValueError(f"tree has {len(leaves)} leaves, layout expects "
                             f"{self.num_leaves}")

    def empty(self, lead: Tuple[int, ...] = (), device=None,
              dtype: torch.dtype = None) -> torch.Tensor:
        """A zero ``lead + (rows, LANES)`` buffer of ``dtype`` (default:
        the layout's)."""
        return torch.zeros(lead + (self.rows, LANES),
                           dtype=dtype or self.dtype, device=device)

    def flatten(self, tree: Pytree, out: torch.Tensor = None) -> torch.Tensor:
        """Template-shaped tree → ``(rows, LANES)`` buffer."""
        leaves = tree_leaves(tree)
        self._check(leaves)
        dev = leaves[0].device if leaves else None
        buf = self.empty(device=dev) if out is None else out
        flat = buf.view(-1)
        for i, l in enumerate(leaves):
            if self.sizes[i]:
                off = self.leaf_sub_offsets[i] * SUB
                flat[off:off + self.sizes[i]].copy_(l.reshape(-1))
        return buf

    def flatten_stacked(self, tree: Pytree) -> torch.Tensor:
        """Stacked ``(W, …leaf)`` tree → ``(W, rows, LANES)`` buffer."""
        leaves = tree_leaves(tree)
        self._check(leaves)
        W = leaves[0].shape[0]
        buf = self.empty((W,), device=leaves[0].device)
        flat = buf.view(W, -1)
        for i, l in enumerate(leaves):
            if self.sizes[i]:
                off = self.leaf_sub_offsets[i] * SUB
                flat[:, off:off + self.sizes[i]].copy_(l.reshape(W, -1))
        return buf

    # -- scatter back -------------------------------------------------------

    def _out_dtypes(self, like: Any):
        if like is None:
            return self.dtypes
        if isinstance(like, torch.dtype):
            return (like,) * self.num_leaves
        return tuple(l.dtype for l in tree_leaves(like))

    def _unflatten(self, flat: torch.Tensor, lead: Tuple[int, ...],
                   like: Any) -> Pytree:
        dts = self._out_dtypes(like)
        leaves = []
        for i, shape in enumerate(self.shapes):
            size = self.sizes[i]
            off = self.leaf_sub_offsets[i] * SUB
            seg = flat[..., off:off + size].reshape(lead + shape)
            leaves.append(seg.to(dts[i]))
        return tree_unflatten(self.treedef, leaves)

    def unflatten(self, buf: torch.Tensor, like: Any = None) -> Pytree:
        """``(rows, LANES)`` buffer → template tree.  Leaves of ``buf``'s
        dtype are views of it; other dtypes are cast copies."""
        return self._unflatten(buf.reshape(-1), (), like)

    def unflatten_stacked(self, buf: torch.Tensor, like: Any = None
                          ) -> Pytree:
        """``(W, rows, LANES)`` buffer → stacked template tree (views for
        leaves of ``buf``'s dtype)."""
        W = buf.shape[0]
        return self._unflatten(buf.reshape(W, self.rows * LANES), (W,), like)

    # -- the compact per-client view (the fleet population) -----------------
    #
    # ``flatten_stacked`` pads every leaf to whole sub-blocks and the buffer
    # to whole BLOCK_ROWS blocks, the plane's unit of work; a population
    # mirror held for EVERY client cannot afford that (a 4-element convex
    # leaf costs 32,768 elements a client).  The compact view keeps the leaf
    # order and the buffer dtype, pads each leaf only to whole LANES
    # vectors and has no tail: one ``(W, packed_cols)`` array, cheap to
    # gather and scatter along the client dim.

    @property
    def leaf_lanes(self) -> Tuple[int, ...]:
        """LANES-vectors per leaf in the compact view (0 for empty leaves)."""
        return tuple(-(-s // LANES) for s in self.sizes)

    @property
    def leaf_lane_offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for n in self.leaf_lanes:
            offs.append(acc)
            acc += n
        return tuple(offs)

    @property
    def packed_cols(self) -> int:
        """Columns of the compact ``(W, packed_cols)`` per-client view."""
        return sum(self.leaf_lanes) * LANES

    def packed_segments(self):
        """``(compact offset, plane offset, size)`` of every non-empty leaf:
        where it sits in a compact row and in a flat plane buffer."""
        return [(c * LANES, self.leaf_sub_offsets[i] * SUB, self.sizes[i])
                for i, c in enumerate(self.leaf_lane_offsets)
                if self.sizes[i]]

    def pack_stacked(self, tree: Pytree) -> torch.Tensor:
        """Stacked ``(W, …leaf)`` tree → compact ``(W, packed_cols)`` buffer
        of the layout's dtype (zero LANES padding)."""
        leaves = tree_leaves(tree)
        self._check(leaves)
        W = leaves[0].shape[0]
        out = torch.zeros((W, self.packed_cols), dtype=self.dtype,
                          device=leaves[0].device)
        offs = self.leaf_lane_offsets
        for i, l in enumerate(leaves):
            size = self.sizes[i]
            if size:
                c = offs[i] * LANES
                out[:, c:c + size].copy_(l.reshape(W, size))
        return out

    def unpack_stacked(self, buf: torch.Tensor, like: Any = None) -> Pytree:
        """Compact ``(W, packed_cols)`` buffer → stacked template tree
        (views for leaves of ``buf``'s dtype)."""
        W = buf.shape[0]
        dts = self._out_dtypes(like)
        offs = self.leaf_lane_offsets
        leaves = []
        for i, shape in enumerate(self.shapes):
            off = offs[i] * LANES
            seg = buf[:, off:off + self.sizes[i]].reshape((W,) + shape)
            leaves.append(seg.to(dts[i]))
        return tree_unflatten(self.treedef, leaves)
