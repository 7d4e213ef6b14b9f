"""Mesh builders — port of ``repro.launch.mesh``.

``make_mesh`` wraps ``torch.distributed.device_mesh.init_device_mesh``
over the ranks of the initialised group (one device a rank: the card
by default, the CPU when asked for).  ``make_production_mesh`` keeps the
reference's TPU v5e shapes as a description (:class:`MeshShape`) and
touches no device, so importing or calling it needs none; ``data_axes``
and ``batch_shards`` read either kind.  ``mesh_context`` makes a mesh
current for the model's activation constraint (``act_shard_axes``), as the
reference's ``jax.set_mesh`` / ``with mesh`` does.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple, Tuple


class MeshShape(NamedTuple):
    """A mesh's shape and axis names, without devices."""
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.dims))


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with ``axes`` names over the group's
    ranks (their product must be the world size)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


_CURRENT: List = []


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` or a :class:`MeshShape`) current
    inside the block: the mesh that ``ModelConfig.act_shard_axes`` pins
    activations to (``current_mesh``).  Blocks nest; the innermost wins."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost :func:`mesh_context`'s mesh, None outside every one."""
    return _CURRENT[-1] if _CURRENT else None


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """TPU v5e target: 16×16 = 256 chips per pod; 2 pods = 512 chips (the
    reference's shapes, as a description)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh(device_type: str = "cuda"):
    """Whatever this group has — a world × 1 ("data", "model") mesh."""
    import torch.distributed as dist
    return make_mesh((dist.get_world_size(), 1), ("data", "model"),
                     device_type)


def _names_sizes(mesh):
    if isinstance(mesh, MeshShape):
        return mesh.axis_names, mesh.dims
    return tuple(mesh.mesh_dim_names), tuple(mesh.shape)


def data_axes(mesh) -> tuple:
    """The batch-sharding axes of a mesh (everything except 'model')."""
    return tuple(n for n in _names_sizes(mesh)[0] if n != "model")


def batch_shards(mesh) -> int:
    names, sizes = _names_sizes(mesh)
    size = dict(zip(names, sizes))
    return math.prod(size[a] for a in data_axes(mesh))
