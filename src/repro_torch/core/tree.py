"""Pytrees in JAX's leaf order.

``torch.utils._pytree`` flattens dicts in insertion order; JAX flattens them
in SORTED key order.  The flat-buffer layout (``repro_torch.fastpath.
layout``) and LAQ's per-leaf quantizer scales depend on the leaf order, so
the port flattens with JAX's rules: dict children by sorted key, list and
tuple children in order (a ``NamedTuple`` by field, rebuilt as its own
type), ``None`` as an empty node, anything else (a tensor, a numpy array, a
scalar) as a leaf.
:func:`tree_paths` names each leaf as ``jax.tree_util.keystr`` does
(``"['params']['blocks']['0']['attn']['wq']"``), the strings the
placement rules of ``repro_torch.dist.sharding`` key on.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Pytree = Any

# treedef nodes: ("leaf",) | ("none",) | ("dict", keys, children) |
#                ("list", children) | ("tuple", children) |
#                ("named", type, children)
TreeDef = Tuple


def _flatten(t, leaves: List[Any], is_leaf) -> TreeDef:
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        return ("leaf",)
    if t is None:
        return ("none",)
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_flatten(t[k], leaves, is_leaf)
                                    for k in keys))
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return ("named", type(t), tuple(_flatten(c, leaves, is_leaf)
                                        for c in t))
    if isinstance(t, (list, tuple)):
        kind = "list" if isinstance(t, list) else "tuple"
        return (kind, tuple(_flatten(c, leaves, is_leaf) for c in t))
    leaves.append(t)
    return ("leaf",)


def tree_flatten(tree: Pytree, is_leaf: Optional[Callable] = None
                 ) -> Tuple[List[Any], TreeDef]:
    """(leaves, treedef); ``is_leaf(node)`` True stops the descent there.

    The recursion is a module-level function, not a closure: a recursive
    closure is a reference cycle that keeps its leaves alive until the
    cyclic garbage collector runs, which on the card can hold several
    model-sized trees at once."""
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves, is_leaf)
    return leaves, treedef


def _unflatten(d: TreeDef, it) -> Pytree:
    kind = d[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(d[1], d[2])}
    if kind == "named":
        return d[1](*[_unflatten(c, it) for c in d[2]])
    children = [_unflatten(c, it) for c in d[1]]
    return children if kind == "list" else tuple(children)


def tree_unflatten(treedef: TreeDef, leaves) -> Pytree:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over after unflatten")
    return out


def _paths(t, prefix: str, out: List[str], is_leaf) -> None:
    if is_leaf is not None and is_leaf(t):
        out.append(prefix)
    elif t is None:
        return
    elif isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], f"{prefix}[{k!r}]", out, is_leaf)
    elif isinstance(t, tuple) and hasattr(t, "_fields"):
        for k, c in zip(t._fields, t):
            _paths(c, f"{prefix}.{k}", out, is_leaf)
    elif isinstance(t, (list, tuple)):
        for i, c in enumerate(t):
            _paths(c, f"{prefix}[{i}]", out, is_leaf)
    else:
        out.append(prefix)


def tree_paths(tree: Pytree, is_leaf: Optional[Callable] = None
               ) -> List[str]:
    """Each leaf's path in :func:`tree_flatten`'s order, spelled as
    ``jax.tree_util.keystr`` spells it: ``[<key>!r]`` for a dict key,
    ``[i]`` for a list or tuple index, ``.<field>`` for a NamedTuple's."""
    out: List[str] = []
    _paths(tree, "", out, is_leaf)
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
