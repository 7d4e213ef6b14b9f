"""Rule-based placement: leaf path + shape → PartitionSpec — port of
``repro.dist.sharding``.

The rules are the reference's, verbatim: pure Python over a leaf's path
(as ``repro_torch.core.tree.tree_paths`` spells it, ``jax.tree_util.
keystr``'s strings) and its shape, so they give the reference's spec for
every leaf of every state group:

* **params** — explicit rules per leaf kind (attention heads, MoE experts,
  embedding vocab, MLP ffn) shard the *non-contracting* dim over the
  ``"model"`` axis; contracting dims stay unsharded.  Leaves a rule cannot
  divide fall back replicated, except the generic rule below (which the
  stacked norm scales reach, and where they take ``"data"``).
* **memory gate** — any parameter still >2 GiB/device (bf16 estimate) after
  model-sharding gets the data axes on its largest remaining divisible dim.
* **lag state** — ``state['lag']`` leaves (``grad_hat``/``theta_hat`` with
  their leading worker dim, and the aggregate ``nabla``) are never
  contracted, so after the worker dim is protected they additionally take
  the data axes on their largest free dim.
* **kv caches** — batch over data, sequence over model.
* **dp mode** — pure data parallelism: weights replicated, the LAG worker
  dim rides the data axis.

``tree_specs`` / ``batch_specs`` map a whole state tree / input batch (the
leading 3 of mRoPE ``positions3`` is never a batch dim).  The mesh is
duck-typed, as in the reference: a ``launch.mesh.MeshShape``, a
``DeviceMesh`` (``mesh_dim_names`` and ``shape``), or anything with
``axis_names`` and a ``shape`` mapping (the tests' ``FakeMesh``).

The torch half: :func:`placements` turns a spec into one DTensor
``Placement`` per mesh dim, and :func:`tree_shardings` /
:func:`batch_shardings` place a tree or a batch on a ``DeviceMesh`` as
DTensors (``distribute_tensor``).  The trainer's own row-sharded state
(``repro_torch.dist.row_shards``) asks :func:`spec_for` which of its flat
buffers the rules shard over ``"data"``; :func:`row_shard_records` predicts
the collectives of its round, byte for byte.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_paths,
                                   tree_unflatten)

Pytree = Any

_KEY_RE = re.compile(r"\[['\"]?([^'\"\]]+)['\"]?\]")

# memory gate: per-device bytes above which a second (data) axis is added.
# Production runs bf16 params, so the estimate charges 2 bytes/element.
GATE_BYTES = 2 * 2 ** 30
GATE_BYTES_PER_EL = 2


class PartitionSpec(tuple):
    """A leaf's placement: one entry per dim, ``None`` (replicated), an
    axis name, or a tuple of names (sharded over their product).  Equality
    is the reference's: entry by entry, a one-name tuple the same as the
    bare name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _keys(path: str) -> list:
    """``"['params']['blocks']['0']['attn']['wq']"`` → list of key strings."""
    return _KEY_RE.findall(path)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                 # a DeviceMesh: shape is a tuple
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(n) for a, n in dict(mesh.shape).items()}


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _model_size(mesh) -> int:
    return int(mesh_shape(mesh).get("model", 1))


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a != "model")


def _data_size(mesh) -> int:
    shp = mesh_shape(mesh)
    return int(math.prod(shp[a] for a in _data_axes(mesh)) or 1)


def _data_entry(mesh):
    """The spec entry for "all data axes": a bare name for a single axis,
    the flattened tuple (e.g. ``("pod", "data")``) on multi-pod meshes."""
    axes = _data_axes(mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _div(dim: int, n: int) -> bool:
    return n > 1 and dim > 0 and dim % n == 0


def _with(spec: list, idx: int, entry) -> list:
    out = list(spec)
    out[idx] = entry
    return out


def _densify(spec: list, shape: Sequence[int], mesh,
             skip: Tuple[int, ...] = ()) -> list:
    """Add the data axes to the largest unsharded divisible dim (used for
    LAG state and the memory gate — leaves that are never contracted)."""
    n = _data_size(mesh)
    entry = _data_entry(mesh)
    if entry is None or any(s is not None and s != "model" for s in spec):
        return spec                       # data axes already in use
    cands = [(shape[i], i) for i in range(len(shape))
             if spec[i] is None and i not in skip and _div(shape[i], n)]
    if not cands:
        return spec
    _, idx = max(cands)
    return _with(spec, idx, entry)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

def _param_spec(keys: Sequence[str], shape: Sequence[int], mesh,
                mode: str = "tp", gate: bool = True) -> list:
    """Spec (as a list of entries) for a model-parameter-like leaf."""
    nd = len(shape)
    spec = [None] * nd
    if mode == "dp":                      # pure data parallel: replicate
        return spec
    if nd <= 1:                           # scalars / biases / norm scales
        return spec
    m = _model_size(mesh)
    last = keys[-1] if keys else ""
    parent = keys[-2] if len(keys) >= 2 else ""

    if last in ("embed", "mask_emb"):
        # (vocab, d): vocab over model when divisible; d is the contracting
        # dim of both the lookup and the tied head — never sharded here
        if _div(shape[-2], m):
            spec = _with(spec, nd - 2, "model")
    elif last == "head":
        # (d, vocab): output vocab over model; d contracting
        if _div(shape[-1], m):
            spec = _with(spec, nd - 1, "model")
    elif parent == "attn" or last in ("wq", "wk", "wv", "wo",
                                      "bq", "bk", "bv"):
        # wq/wk/wv (…, d, H, hd): heads at −2;  wo (…, H, hd, d): heads at −3
        h = nd - 3 if last == "wo" else nd - 2
        if 0 <= h < nd and _div(shape[h], m):
            spec = _with(spec, h, "model")
    elif parent == "moe":
        if last == "router":              # (…, d, E): experts over model
            if _div(shape[-1], m):
                spec = _with(spec, nd - 1, "model")
        elif nd >= 3:                     # (…, E, din, dout): expert parallel
            e = nd - 3
            if _div(shape[e], m):
                spec = _with(spec, e, "model")
    elif parent == "mlp" or last in ("w_up", "w_gate", "w_down"):
        # ffn dim over model: last dim for up/gate, −2 for down (row-parallel)
        f = nd - 2 if last == "w_down" else nd - 1
        if _div(shape[f], m):
            spec = _with(spec, f, "model")
    elif last in ("k", "v") and nd >= 4:
        # KV cache (…, B, S, kv_heads, hd): batch over data, seq over model
        b, s = nd - 4, nd - 3
        if _div(shape[b], _data_size(mesh)):
            spec = _with(spec, b, _data_entry(mesh))
        if _div(shape[s], m):
            spec = _with(spec, s, "model")
        return spec                       # caches never take the gate
    else:
        # generic fallback: biggest divisible dim over model, next over data
        order = sorted(range(nd), key=lambda i: -shape[i])
        for i in order:
            if _div(shape[i], m):
                spec = _with(spec, i, "model")
                break
        for i in order:
            if spec[i] is None and _div(shape[i], _data_size(mesh)):
                spec = _with(spec, i, _data_entry(mesh))
                break
        return spec

    if gate:
        spec = _memory_gate(spec, shape, mesh)
    return spec


def _memory_gate(spec: list, shape: Sequence[int], mesh) -> list:
    """>2 GiB/device after model-sharding ⇒ add the data axes too."""
    if any(s is not None and s != "model" for s in spec):
        return spec                       # data axes already in use
    sharded = math.prod(_axis_size(mesh, s) for s in spec if s is not None)
    per_dev = math.prod(shape) / max(sharded, 1) * GATE_BYTES_PER_EL
    if per_dev <= GATE_BYTES:
        return spec
    return _densify(spec, shape, mesh)


def _axis_size(mesh, entry) -> int:
    shp = mesh_shape(mesh)
    if isinstance(entry, tuple):
        return int(math.prod(shp[a] for a in entry))
    return int(shp.get(entry, 1))


# ---------------------------------------------------------------------------
# LAG state rules
# ---------------------------------------------------------------------------

def _lag_spec(keys: Sequence[str], shape: Sequence[int], mesh,
              mode: str) -> list:
    kind = keys[1] if len(keys) > 1 else ""
    if kind in ("grad_hat", "theta_hat"):
        # leading worker dim is the lazy-aggregation unit — PROTECTED from
        # model/data sharding in tp mode; in dp mode it rides the data axes
        # (worker shards colocated with their data shards)
        sub = keys[2:] or keys[1:]
        base = _param_spec(sub, shape[1:], mesh, mode="tp", gate=False)
        if mode == "dp":
            entry = _data_entry(mesh)
            w = entry if entry is not None and \
                _div(shape[0], _data_size(mesh)) else None
            return [w] + base
        return [None] + _densify(base, shape[1:], mesh)
    if kind == "nabla":
        if mode == "dp":
            return [None] * len(shape)    # aggregate is replicated under dp
        base = _param_spec(keys[2:] or keys[1:], shape, mesh, mode="tp",
                           gate=False)
        return _densify(base, shape, mesh)
    # hist / comm counters / L_m / rounds_skipped: tiny, replicated
    return [None] * len(shape)


# ---------------------------------------------------------------------------
# Public API: the rules
# ---------------------------------------------------------------------------

def spec_for(path: str, shape: Sequence[int], mesh, mode: str = "tp"
             ) -> PartitionSpec:
    """PartitionSpec for one state leaf.

    ``path`` is a ``jax.tree_util.keystr``-style path (``"['params']…"``),
    ``mode`` is ``"tp"`` (tensor/model parallel rules, the default) or
    ``"dp"`` (replicated weights, worker dim on the data axes).
    """
    keys = _keys(path)
    if keys and keys[0] == "lag":
        return P(*_lag_spec(keys, shape, mesh, mode))
    if keys and keys[0] == "opt":
        # optimizer moments mirror the params they precondition
        return P(*_param_spec(keys[2:] or keys[1:], shape, mesh, mode))
    return P(*_param_spec(keys, shape, mesh, mode))


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _with_paths(fn, tree: Pytree) -> Pytree:
    """``fn(path, leaf)`` over ``tree``'s leaves, in its shape."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(p, l) for p, l in
                                    zip(tree_paths(tree), leaves)])


def tree_specs(tree: Pytree, mesh, mode: str = "tp") -> Pytree:
    """Map ``spec_for`` over a state tree (of anything with a ``shape``:
    tensors, meta tensors, the reference's ShapeDtypeStructs)."""
    return _with_paths(lambda path, leaf: spec_for(
        path, tuple(leaf.shape), mesh, mode), tree)


def batch_specs(batch: Dict[str, Any], mesh, seq_shard: bool = True,
                mode: str = "tp") -> Pytree:
    """Input-batch placement: batch dim over the (flattened) data axes,
    sequence dim over model when ``seq_shard`` (tp mode only).  The leading
    3 of mRoPE ``positions3`` is never a batch dim."""
    m = _model_size(mesh)

    def one(path, leaf):
        key = _keys(path)[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return P()
        spec = [None] * nd
        b = 1 if key == "positions3" else 0
        if b < nd and _div(shape[b], _data_size(mesh)):
            spec = _with(spec, b, _data_entry(mesh))
        s = b + 1
        if seq_shard and mode == "tp" and s < nd and _div(shape[s], m):
            spec = _with(spec, s, "model")
        return P(*spec)

    return _with_paths(one, batch)


# ---------------------------------------------------------------------------
# The torch half: DTensor placements on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec: PartitionSpec, mesh) -> List:
    """One DTensor ``Placement`` per dim of ``mesh``: ``Shard(i)`` where
    entry i of ``spec`` names that mesh dim (an entry naming several axes
    shards dim i over each of them), ``Replicate()`` where none does."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _distribute(specs: Pytree, tree: Pytree, mesh) -> Pytree:
    from torch.distributed.tensor import distribute_tensor
    leaves = tree_leaves(tree)
    spec_leaves, treedef = tree_flatten(specs, is_leaf=_is_spec)
    return tree_unflatten(treedef, [
        distribute_tensor(t, mesh, placements(s, mesh))
        for s, t in zip(spec_leaves, leaves)])


def tree_shardings(tree: Pytree, mesh, mode: str = "tp") -> Pytree:
    """``tree``'s tensors placed on the ``DeviceMesh`` by their
    ``tree_specs``: DTensors made by ``distribute_tensor`` (every rank
    passes the same whole tensors; each keeps its shard)."""
    return _distribute(tree_specs(tree, mesh, mode), tree, mesh)


def batch_shardings(batch: Dict[str, Any], mesh, seq_shard: bool = True,
                    mode: str = "tp") -> Pytree:
    """``batch`` placed on the ``DeviceMesh`` by its ``batch_specs``."""
    return _distribute(batch_specs(batch, mesh, seq_shard=seq_shard,
                                   mode=mode), batch, mesh)


def local_slices(spec: PartitionSpec, shape: Sequence[int], mesh,
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The index of the shard that the device at ``coords`` ({axis: index})
    holds of a leaf of ``shape`` under ``spec`` (even splits, as the rules
    only shard divisible dims; the axes of a tuple entry major to minor)."""
    shp = mesh_shape(mesh)
    out = []
    for d, entry in zip(shape, spec):
        if entry is None:
            out.append(slice(None))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(shp[a] for a in axes)
        i = 0
        for a in axes:
            i = i * shp[a] + coords.get(a, 0)
        out.append(slice(i * (d // n), (i + 1) * (d // n)))
    return tuple(out)


def shard_bytes(spec: PartitionSpec, nbytes: int, mesh) -> int:
    """A leaf's bytes on each device under ``spec``: its bytes over the
    product of the mesh axes its spec names (the rules only shard
    divisible dims, so the division is exact)."""
    n = math.prod(_axis_size(mesh, e) for e in spec if e is not None)
    return nbytes // n


# ---------------------------------------------------------------------------
# The row-sharded trainer's collectives, predicted
# ---------------------------------------------------------------------------

def row_shard_records(policy, *, workers: int, ranks: int, shard_rows: int,
                      itemsize: int, opt_itemsizes: Sequence[int] = ()
                      ) -> List[dict]:
    """The collective records one round of the row-sharded trainer
    (``repro_torch.dist.row_shards``) writes on each rank, in the
    ``collectives.collective_bytes`` form: the workers' gradient rows to
    their holders (one all-to-all; LASG-WK's θ̂ rows and its second
    gradients two more), the losses gathered, the plane's per-sub-block
    partials gathered (one per reduction the policy's trigger and encode
    read), and the server's new θ rows and state rows gathered back into
    the replicated buffers.  ``shard_rows`` is each rank's rows R,
    ``itemsize`` the parameters' (θ, θ̂ and the gradients), and
    ``opt_itemsizes`` one entry per flat buffer of the server's state."""
    N, W, R = ranks, workers, shard_rows
    row_bytes = R * 128
    recs = [dict(kind="all-to-all", bytes=W * row_bytes * itemsize,
                 what="grads")]
    if policy.needs_grad_at_hat:
        recs += [dict(kind="all-to-all", bytes=W * row_bytes * itemsize,
                      what=what) for what in ("theta_hat", "grads_at_hat")]
    recs.append(dict(kind="all-gather", bytes=N * (W // N) * 4, what="loss"))
    for what in plane_reductions(policy):
        recs.append(dict(kind="all-gather", bytes=N * W * (R // 8) * 4,
                         what=what))
    recs.append(dict(kind="all-gather", bytes=N * row_bytes * itemsize,
                     what="theta"))
    for i, size in enumerate(opt_itemsizes):
        recs.append(dict(kind="all-gather", bytes=N * row_bytes * size,
                         what=f"opt{i}"))
    for r in recs:
        r["group"] = list(range(N))
    return recs


def plane_reductions(policy) -> Tuple[str, ...]:
    """The per-sub-block partials a policy's batched precompute gathers
    across ranks, in order: LAQ its absmax and its ‖p‖²; the dense
    triggers one squared distance; the GD payload none."""
    from repro_torch.comm import GDPolicy, LAQPolicy
    inner = getattr(policy, "inner", policy)
    if isinstance(inner, LAQPolicy):
        return ("absmax", "laq_sq")
    if isinstance(inner, GDPolicy):
        return ()
    return ("delta_sqnorm",)
