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

``restore(dir, like)`` checks the checkpoint's paths and shapes against
``like`` and writes each array IN PLACE into ``like``'s tensor, on that
tensor's device, one leaf at a time: a full-width restore holds no second
copy of the state on the card.  Python scalars (the step counter) come
back as the same Python type.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten

Pytree = Any

_CKPT_RE = re.compile(r"^step_(\d+)\.npz$")


def _paths(tree: Pytree, prefix: str = "") -> List[str]:
    """Leaf paths in ``tree_flatten``'s order (sorted dict keys)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, c in enumerate(tree)
                for p in _paths(c, f"{prefix}[{i}]")]
    return [prefix]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise NotImplementedError(
                "checkpoint: a bfloat16 leaf is not saved: numpy has no "
                "bfloat16 (ROADMAP queue 1 item 8)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Pytree) -> str:
    """Write ``tree`` (tensors on any device, Python scalars) as
    ``<ckpt_dir>/step_<step>.npz``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, _ = tree_flatten(tree)
    arrays, manifest = {}, []
    for i, (path, leaf) in enumerate(zip(_paths(tree), leaves)):
        key = f"a{i}"
        arrays[key] = _to_numpy(leaf)
        manifest.append({"key": key, "path": path,
                         "dtype": str(arrays[key].dtype)})
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, __manifest__=np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8), **arrays)
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


def restore(ckpt_dir: str, like: Pytree, step: Optional[int] = None
            ) -> Tuple[Pytree, int]:
    """Restore step ``step`` (the latest by default) into ``like``: every
    tensor leaf is overwritten in place (cast to its dtype, on its device),
    scalar leaves are replaced.  Raises when a path of ``like`` is missing
    from the checkpoint or the checkpoint holds a path ``like`` lacks (a
    different topology or policy), and on a shape mismatch.  Returns
    ``(tree, step)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    leaves, treedef = tree_flatten(like)
    paths = _paths(like)
    with np.load(os.path.join(ckpt_dir, f"step_{step}.npz")) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        keys = {m["path"]: m["key"] for m in manifest}
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
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else np.shape(leaf)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"shape mismatch at {path}: "
                                 f"{arr.shape} vs {shape}")
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(torch.from_numpy(np.asarray(arr, order="C")))
                out.append(leaf)
            else:
                out.append(type(leaf)(arr.item()))
            del arr
    return tree_unflatten(treedef, out), step
