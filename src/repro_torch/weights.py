"""Carry the reference's initial parameters across.

``repro.models.model.init`` draws its weights with ``jax.random``, which
PyTorch cannot reproduce, so parity runs export those parameters to numpy
and hand them over here.  The tree must be the reference's (the leaf order
is JAX's sorted-key order, the layer stack stays one (num_layers, …) leaf
per weight).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.common import ModelConfig


def params_from_reference(tree_of_numpy: Any, cfg: ModelConfig,
                          device="cuda") -> Dict:
    """Reference params (nested dicts of numpy arrays) → the port's params
    (nested dicts of tensors on ``device``, each leaf at its template's
    dtype: a bfloat16 config's float32 leaves stay float32, and
    ``lag_trainer.init_params`` copies them into the float32 part of θ):
    the card by default (raising without one), the CPU when asked."""
    device = resolve_device(device)
    leaves, treedef = tree_flatten(tree_of_numpy)
    want, want_def = tree_flatten(model.templates(cfg))
    if treedef != want_def:
        raise ValueError("reference parameter tree does not match the "
                         f"port's {cfg.arch_id} tree")
    out = []
    for a, t in zip(leaves, want):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"leaf shape {a.shape} != {tuple(t.shape)}")
        out.append(torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=t.dtype))
    return tree_unflatten(treedef, out)
