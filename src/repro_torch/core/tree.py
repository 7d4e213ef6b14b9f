"""Pytrees in JAX's leaf order.

``torch.utils._pytree`` flattens dicts in insertion order; JAX flattens them
in SORTED key order.  The flat-buffer layout (``repro_torch.fastpath.
layout``) and LAQ's per-leaf quantizer scales depend on the leaf order, so
the port flattens with JAX's rules: dict children by sorted key, list and
tuple children in order, ``None`` as an empty node, anything else (a tensor,
a numpy array, a scalar) as a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Pytree = Any

# treedef nodes: ("leaf",) | ("none",) | ("dict", keys, children) |
#                ("list", children) | ("tuple", children)
TreeDef = Tuple


def tree_flatten(tree: Pytree, is_leaf: Optional[Callable] = None
                 ) -> Tuple[List[Any], TreeDef]:
    """(leaves, treedef); ``is_leaf(node)`` True stops the descent there."""
    leaves: List[Any] = []

    def rec(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return ("leaf",)
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return ("dict", keys, tuple(rec(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return (kind, tuple(rec(c) for c in t))
        leaves.append(t)
        return ("leaf",)

    treedef = rec(tree)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves) -> Pytree:
    it = iter(leaves)

    def rec(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: rec(c) for k, c in zip(d[1], d[2])}
        children = [rec(c) for c in d[1]]
        return children if kind == "list" else tuple(children)

    out = rec(treedef)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over after unflatten")
    return out


def tree_leaves(tree: Pytree, is_leaf: Optional[Callable] = None
                ) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree,
             is_leaf: Optional[Callable] = None) -> Pytree:
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_leaves(r, is_leaf) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: {len(leaves)} vs {len(o)} leaves")
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])
