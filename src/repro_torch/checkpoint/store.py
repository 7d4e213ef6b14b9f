"""Checkpoints of the port's trainer state — port of
``repro.checkpoint.store``, in its file format.

A checkpoint is ``step_<n>.npz``: one array per leaf of the state dict
plus a JSON ``__manifest__`` of ``{key, path, dtype}``, written to a
temporary file and moved into place with ``os.replace`` (a crash never
leaves a torn ``step_<n>.npz``).  The paths are the state dict's own keys
in the reference's notation (``['lag']['grad_hat']``), leaves in sorted-key
order.  Everything a topology adds to the state — the async ring, the
pods' skip counter, the fleet's compact population, the graph's stacked
node iterates and per-edge mirrors, the server's state — is algorithm
state (losing the mirrors would silently reset every unit's trigger), so
all of it is saved.

A bfloat16 tensor is written in the reference's bytes: numpy has no
bfloat16, so the entry holds the raw 2-byte words under the header the
reference's ``ml_dtypes`` array gets (descr ``'<V2'``; numpy reads it back
as ``|V2``), and the manifest names it ``"bfloat16"``.  A ``Parts`` pair
(a tree of 2-byte and float32 leaves) is a node of two leaves, ``.b``
and ``.f`` in the paths, as JAX names a NamedTuple's fields.  A float16
tensor is numpy's own float16 entry, which the reference reads back.

``restore(dir, like)`` checks the checkpoint's paths and shapes against
``like`` and writes each array IN PLACE into ``like``'s tensor, on that
tensor's device, one leaf at a time: a full-width restore holds no second
copy of the state on the card.  An entry the manifest calls
``"bfloat16"`` (the port's or the reference's) is read back as bfloat16
bit for bit.  Python scalars (the step counter) come back as the same
Python type.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten

Pytree = Any

_CKPT_RE = re.compile(r"^step_(\d+)\.npz$")


_BF16 = "bfloat16"
#: the header descr of the reference's bfloat16 entries (``ml_dtypes``'
#: dtype string); numpy itself writes a void dtype as ``'|V2'``
_BF16_DESCR = "<V2"


def _paths(tree: Pytree, prefix: str = "") -> List[str]:
    """Leaf paths in ``tree_flatten``'s order (sorted dict keys)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for k, c in zip(tree._fields, tree)
                for p in _paths(c, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, c in enumerate(tree)
                for p in _paths(c, f"{prefix}[{i}]")]
    return [prefix]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the entry's array, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view("V2"), _BF16
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _savez(path: str, arrays) -> None:
    """``np.savez``'s archive (stored members ``<key>.npy``), with a
    bfloat16 entry's header descr the reference's."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dt) in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dt == _BF16:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": arr.shape})
                    fid.write(np.ascontiguousarray(arr).reshape(-1)
                              .view(np.uint8))
                else:
                    np.lib.format.write_array(fid, arr, allow_pickle=False)


def save(ckpt_dir: str, step: int, tree: Pytree) -> str:
    """Write ``tree`` (tensors on any device, Python scalars) as
    ``<ckpt_dir>/step_<step>.npz``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, _ = tree_flatten(tree)
    arrays, manifest = {}, []
    for i, (path, leaf) in enumerate(zip(_paths(tree), leaves)):
        key = f"a{i}"
        arrays[key] = _to_numpy(leaf)
        manifest.append({"key": key, "path": path, "dtype": arrays[key][1]})
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    tmp = path + ".tmp.npz"
    _savez(tmp, dict(__manifest__=(np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8), "uint8"), **arrays))
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest checkpoint's step in ``ckpt_dir``, None when there is
    none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := _CKPT_RE.match(f))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Pytree, step: Optional[int] = None,
            take: Optional[Dict[str, Any]] = None) -> Tuple[Pytree, int]:
    """Restore step ``step`` (the latest by default) into ``like``: every
    tensor leaf is overwritten in place (cast to its dtype, on its device),
    scalar leaves are replaced.  Raises when a path of ``like`` is missing
    from the checkpoint or the checkpoint holds a path ``like`` lacks (a
    different topology or policy), and on a shape mismatch.  ``take``
    maps a path to a worker: the checkpoint's entry there has a leading
    worker dim, and that worker's slot alone is restored (a rank of the
    device plane restores its own mirror state from a ``shards:D`` file);
    or to an index (a tuple of slices), and that part of the entry alone is
    restored (a rank of the row-sharded trainer restores its rows).
    Returns ``(tree, step)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    leaves, treedef = tree_flatten(like)
    paths = _paths(like)
    with np.load(os.path.join(ckpt_dir, f"step_{step}.npz")) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        keys = {m["path"]: m["key"] for m in manifest}
        bf16 = {m["key"] for m in manifest if m["dtype"] == _BF16}
        missing = [p for p in paths if p not in keys]
        if missing:
            raise KeyError(f"checkpoint missing leaf {missing[0]} "
                           f"({len(missing)} missing)")
        extra = sorted(set(keys) - set(paths))
        if extra:
            raise KeyError(f"checkpoint leaf {extra[0]} is not in the state "
                           f"to restore ({len(extra)} such leaves)")
        out = []
        for path, leaf in zip(paths, leaves):
            arr = z[keys[path]]
            if take and path in take:
                t = take[path]
                arr = arr[t:t + 1] if isinstance(t, int) else arr[t]
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else np.shape(leaf)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"shape mismatch at {path}: "
                                 f"{arr.shape} vs {shape}")
            if isinstance(leaf, torch.Tensor):
                src = torch.from_numpy(np.asarray(arr, order="C").view(
                    np.int16)).view(torch.bfloat16) if keys[path] in bf16 \
                    else torch.from_numpy(np.asarray(arr, order="C"))
                leaf.copy_(src)
                out.append(leaf)
            else:
                out.append(type(leaf)(arr.item()))
            del arr
    return tree_unflatten(treedef, out), step
