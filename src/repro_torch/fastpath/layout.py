"""Static flat-buffer layout: ONE padded ``(rows, 128)`` view of a pytree —
port of ``repro.fastpath.layout``.

Each leaf is flattened, cast to the buffer's dtype (:func:`buffer_dtype`:
float64 for a tree with a float64 leaf, bfloat16 (float16) for a tree of
bfloat16 (float16) leaves only, else float32) and padded up to whole
sub-blocks (``SUB_ROWS`` × ``LANES`` = 1024 elements), so a sub-block
never straddles two leaves and per-leaf quantities (LAQ's quantizer scale,
the fixed-order per-(worker, leaf) partial sums) survive batching.  The buffer tail is
padded to whole ``BLOCK_ROWS`` blocks; ``sub_leaf`` maps every sub-block to
its leaf (tail sub-blocks map to leaf 0 — they are all-zero, absorbing for
every plane op).  The constants are the reference's: ``rows``, ``sub_leaf``
and LAQ's per-leaf grid depend on them.

The port keeps per-worker state natively in these buffers.  ``unflatten``
returns VIEWS (no copy) for leaves of the buffer's own dtype, so a tree of
model parameters or mirror state can live inside one flat buffer.

A tree that mixes one 2-byte float dtype (bfloat16 or float16) with
float32 leaves (a bfloat16 or float16 config's MoE router, mamba2's
``A_log``/``dt_bias``/``D``, RG-LRU's ``b_a``/``b_i``) has no one buffer
dtype that rounds nothing and widens nothing: :class:`MixedLayout` gives it
two parts, a :class:`FlatLayout` over its 2-byte leaves and one over its
float32 leaves, each in tree order, and its state buffers are
:class:`Parts` pairs.  A tree that mixes bfloat16 with float16 raises (no
config of the reference has one).  The reference casts every
leaf to float32 for its plane and scatters each back at the leaf's dtype;
here every leaf stays at its own dtype between operations.

:class:`RowShard` cuts a layout's rows into N contiguous ranges of whole
``BLOCK_ROWS`` blocks, one a rank (the row-sharded trainer,
``repro_torch.dist.row_shards``): every sub-block, and so every per-leaf
partial, lies whole on one rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)

Pytree = Any

LANES = 128
SUB_ROWS = 8                    # (8, 128) f32 tile — the leaf-padding unit
SUB = SUB_ROWS * LANES          # 1024 elements per sub-block
BLOCK_ROWS = 256                # buffer-tail padding unit (rows)
SUBS_PER_BLOCK = BLOCK_ROWS // SUB_ROWS
BLOCK = BLOCK_ROWS * LANES

#: leaf dtypes the flat plane serves; everything is computed in float32
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

#: the 2-byte float dtypes a buffer (or a mixed tree's first part) holds
HALF_DTYPES = (torch.bfloat16, torch.float16)


def buffer_dtype(dtypes) -> torch.dtype:
    """The flat buffers' dtype for leaves of ``dtypes``: float64 when one
    of them is float64 (the x64 convex runs, which the plane refuses), so
    that flattening rounds nothing; bfloat16 (float16) when every leaf is
    bfloat16 (float16): a 2-byte model's leaves stay views of a buffer of
    their dtype, half the bytes; float32 otherwise.  A tree that mixes a
    2-byte dtype with float32 leaves gets float32 here
    (:func:`mixed_leaves`); it trains in a :class:`MixedLayout`, whose
    parts have one dtype each."""
    dts = tuple(dtypes)
    if torch.float64 in dts:
        return torch.float64
    for half in HALF_DTYPES:
        if dts and all(d == half for d in dts):
            return half
    return torch.float32


def half_dtype(dtypes):
    """The one 2-byte float dtype among ``dtypes`` (None for none);
    raises for bfloat16 beside float16."""
    found = set(dtypes) & set(HALF_DTYPES)
    if len(found) > 1:
        raise TypeError("a tree of bfloat16 and float16 leaves has no "
                        "layout (no config of the reference mixes them)")
    return found.pop() if found else None


def mixed_leaves(dtypes) -> bool:
    """True for a tree that mixes 2-byte float leaves (bfloat16 or
    float16) with leaves of another dtype: a bfloat16 or float16 config
    that keeps float32 leaves (the MoE router, mamba2's
    ``A_log``/``dt_bias``/``D``, RG-LRU's ``b_a``/``b_i``)."""
    dts = set(dtypes)
    return half_dtype(dts) is not None and len(dts) > 1


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

    @property
    def parts(self) -> Tuple["FlatLayout"]:
        """The layout's parts (as :class:`MixedLayout`'s): itself."""
        return (self,)

    def split(self, leaves):
        """The tree's leaves → one list per part: here the one part."""
        self._check(leaves)
        return (list(leaves),)

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
        """``(compact offset, part, plane offset, size)`` of every non-empty
        leaf: where it sits in a compact row and in the flat plane buffer
        of its part (here the one part, 0)."""
        return [(c * LANES, 0, self.leaf_sub_offsets[i] * SUB, self.sizes[i])
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


# ---------------------------------------------------------------------------
# Trees of two dtypes
# ---------------------------------------------------------------------------

class Parts(NamedTuple):
    """The state buffer of a :class:`MixedLayout` tree: ``b`` over its
    2-byte leaves (bfloat16 or float16), ``f`` over its float32 leaves,
    each a flat ``(…, rows, 128)`` buffer of its own part's rows.  A
    part's dtype is the state's: the leaves' own for θ, ∇, the gradients
    and θ̂ (``b`` bfloat16 or float16, ``f`` float32), the 2-byte dtype in
    both for a 2-byte ĝ, float32 in both for LAQ's residual.
    ``repro_torch.core.tree`` sees a node of two leaves, so ``tree_map``
    steps each part at its own dtype."""
    b: torch.Tensor
    f: torch.Tensor


Buffer = Union[torch.Tensor, Parts]


def parts_of(buf) -> Tuple:
    """The tensors of a state buffer: a :class:`Parts`' two, else the one
    buffer itself."""
    return tuple(buf) if isinstance(buf, Parts) else (buf,)


def like_parts(buf, items) -> Buffer:
    """``items`` (one per part of ``buf``) in ``buf``'s form."""
    return Parts(*items) if isinstance(buf, Parts) else items[0]


def row(buf, m: int) -> Buffer:
    """Worker ``m``'s slot of a stacked buffer (of each part)."""
    return Parts(buf.b[m], buf.f[m]) if isinstance(buf, Parts) else buf[m]


def dtype_of(buf):
    """A buffer's dtype: a :class:`Parts` of the parts' dtypes for a
    pair (what :meth:`MixedLayout.unflatten`'s ``like`` takes)."""
    return tree_map(lambda t: t.dtype, buf)


@dataclasses.dataclass(frozen=True)
class MixedLayout:
    """The layout of a tree of 2-byte float (bfloat16 or float16) and
    float32 leaves: ``parts`` is (the :class:`FlatLayout` of its 2-byte
    leaves, that of its float32 leaves), each in tree order; leaf i is
    leaf ``leaf_index[i]`` of part ``leaf_part[i]``.  Its buffers are
    :class:`Parts`; its methods are :class:`FlatLayout`'s, taking and
    giving pairs."""
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    parts: Tuple[FlatLayout, FlatLayout]
    leaf_part: Tuple[int, ...]
    leaf_index: Tuple[int, ...]

    @classmethod
    def for_tree(cls, tree: Pytree) -> "MixedLayout":
        leaves, treedef = tree_flatten(tree)
        dtypes = tuple(l.dtype for l in leaves)
        half = half_dtype(dtypes)
        if half is None or not set(dtypes) <= {half, torch.float32}:
            raise TypeError(f"a mixed layout holds bfloat16 or float16 "
                            f"and float32 leaves, got "
                            f"{sorted({str(d) for d in dtypes})}")
        part = tuple(int(d == torch.float32) for d in dtypes)
        index, count = [], [0, 0]
        for p in part:
            index.append(count[p])
            count[p] += 1
        return cls(treedef=treedef,
                   shapes=tuple(tuple(int(d) for d in l.shape)
                                for l in leaves),
                   dtypes=dtypes,
                   sizes=tuple(int(np.prod(l.shape, dtype=np.int64))
                               for l in leaves),
                   parts=tuple(FlatLayout.for_tree(
                       [l for l, q in zip(leaves, part) if q == p])
                       for p in (0, 1)),
                   leaf_part=part, leaf_index=tuple(index))

    @property
    def num_leaves(self) -> int:
        return len(self.shapes)

    def split(self, leaves):
        """The tree's leaves (in tree order) → one list per part."""
        if len(leaves) != self.num_leaves:
            raise ValueError(f"tree has {len(leaves)} leaves, layout "
                             f"expects {self.num_leaves}")
        return tuple([l for l, q in zip(leaves, self.leaf_part) if q == p]
                     for p in (0, 1))

    def _join(self, per_part) -> Pytree:
        leaves = [per_part[p][i]
                  for p, i in zip(self.leaf_part, self.leaf_index)]
        return tree_unflatten(self.treedef, leaves)

    def empty(self, lead: Tuple[int, ...] = (), device=None,
              dtype: torch.dtype = None) -> Parts:
        """Zero ``lead + (rows, LANES)`` parts, each at ``dtype`` (default:
        its leaves')."""
        return Parts(*(p.empty(lead, device, dtype) for p in self.parts))

    def flatten(self, tree: Pytree, out: Parts = None) -> Parts:
        outs = parts_of(out) if out is not None else (None, None)
        return Parts(*(p.flatten(ls, out=o) for p, ls, o in zip(
            self.parts, self.split(tree_leaves(tree)), outs)))

    def flatten_stacked(self, tree: Pytree) -> Parts:
        return Parts(*(p.flatten_stacked(ls) for p, ls in zip(
            self.parts, self.split(tree_leaves(tree)))))

    def _likes(self, like):
        if like is None or isinstance(like, torch.dtype):
            return (like, like)
        if isinstance(like, Parts):
            return tuple(like)
        return self.split(tree_leaves(like))

    def unflatten(self, buf: Parts, like: Any = None) -> Pytree:
        """Pair → template tree: each leaf a view of its part's buffer
        where the part holds its dtype.  ``like`` as
        :meth:`FlatLayout.unflatten`'s, or a :class:`Parts` of dtypes."""
        return self._join([tree_leaves(p.unflatten(x, like=lk)) for p, x, lk
                           in zip(self.parts, buf, self._likes(like))])

    def unflatten_stacked(self, buf: Parts, like: Any = None) -> Pytree:
        return self._join([tree_leaves(p.unflatten_stacked(x, like=lk))
                           for p, x, lk in zip(self.parts, buf,
                                               self._likes(like))])

    # -- the compact per-client view: ONE row over all leaves in tree order
    # (the two parts interleave by leaf), as ``FlatLayout.for_tree`` of
    # the whole tree packs it

    @property
    def packed_cols(self) -> int:
        return sum(-(-s // LANES) for s in self.sizes) * LANES

    def packed_segments(self):
        """``(compact offset, part, plane offset, size)`` of every non-empty
        leaf, in tree order: where it sits in a compact row and in the flat
        plane buffer of its part."""
        out, c = [], 0
        for n, p, i in zip(self.sizes, self.leaf_part, self.leaf_index):
            if n:
                out.append((c, p, self.parts[p].leaf_sub_offsets[i] * SUB,
                            n))
            c += -(-n // LANES) * LANES
        return out


Layout = Union[FlatLayout, MixedLayout]


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rank ``rank``'s rows of a ``rows``-row flat buffer cut over
    ``ranks`` ranks.  Every rank owns the same count ``shard_rows`` of
    rows, a multiple of ``BLOCK_ROWS`` (so every ``SUB_ROWS`` sub-block lies
    whole on one rank, and the leaves' padding stays where the one-rank
    layout has it): the buffer's rows are padded to ``padded_rows`` =
    ``ranks`` × ``shard_rows``, and the rows past ``rows`` are zero padding
    on the last ranks (all-zero, absorbing for every plane op, as the
    layout's own tail).  Rank r owns rows ``[start, stop)``; ``valid`` of
    them hold the layout's rows."""
    rows: int
    ranks: int
    rank: int

    def __post_init__(self):
        if self.rows % BLOCK_ROWS or not 0 <= self.rank < self.ranks:
            raise ValueError(f"a row shard needs rows a multiple of "
                             f"{BLOCK_ROWS} and 0 <= rank < ranks, got "
                             f"rows {self.rows}, rank {self.rank} of "
                             f"{self.ranks}")

    @property
    def shard_rows(self) -> int:
        blocks = self.rows // BLOCK_ROWS
        return -(-blocks // self.ranks) * BLOCK_ROWS

    @property
    def padded_rows(self) -> int:
        return self.ranks * self.shard_rows

    @property
    def start(self) -> int:
        return self.rank * self.shard_rows

    @property
    def stop(self) -> int:
        return self.start + self.shard_rows

    @property
    def valid(self) -> int:
        """The layout's rows among this rank's (the rest is padding)."""
        return max(0, min(self.stop, self.rows) - self.start)

    @property
    def row_slice(self) -> slice:
        return slice(self.start, self.stop)

    @property
    def subs(self) -> slice:
        """This rank's sub-blocks, in the padded buffer's numbering."""
        return slice(self.start // SUB_ROWS, self.stop // SUB_ROWS)

    def of(self, buf: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a padded ``(…, padded_rows, LANES)`` buffer
        (a view)."""
        return buf[..., self.start:self.stop, :]

    def layout(self, dtype: torch.dtype) -> FlatLayout:
        """The one-leaf layout of a ``(shard_rows, LANES)`` buffer of
        ``dtype``: what the plain route sees of a shard (elementwise
        payloads only: a norm over it would be a shard's norm)."""
        return FlatLayout.for_tree(
            [torch.empty((self.shard_rows * LANES,), dtype=dtype,
                         device="meta")])

    def sub_leaf(self, lo: FlatLayout) -> np.ndarray:
        """``lo.sub_leaf`` of this rank's sub-blocks (padding: leaf 0)."""
        full = np.zeros((self.padded_rows // SUB_ROWS,), np.int32)
        full[:lo.sub_leaf.shape[0]] = lo.sub_leaf
        return full[self.subs]


def layout_for(tree: Pytree) -> Layout:
    """The layout a tree trains in: :class:`MixedLayout` for a tree that
    mixes a 2-byte float dtype with float32 leaves, else one
    :class:`FlatLayout`."""
    if mixed_leaves(l.dtype for l in tree_leaves(tree)):
        return MixedLayout.for_tree(tree)
    return FlatLayout.for_tree(tree)
