"""Device meshes with the reference's axis names, as
``torch.distributed.device_mesh.DeviceMesh`` objects.

The builders need a started process group whose world size is the mesh's
size (``torchrun`` sets one up; :func:`repro_torch.launch.train.main`
starts it).  The rule helpers (:func:`data_axes`, :func:`mesh_size`,
:func:`axis_names`) also take a stub: an object with ``axis_names`` and
``devices.shape`` (the reference's tests' ``FakeMesh``), or a plain
``(shape, names)`` pair, so the sharding rules run without any device.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

__all__ = ["axis_names", "data_axes", "make_local_mesh", "make_mesh",
           "make_production_mesh", "mesh_size"]


def make_mesh(shape: Sequence[int], names: Sequence[str], device=None):
    """A DeviceMesh of ``shape`` with axes ``names`` over the started process
    group, on CUDA unless ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device) if device is not None else torch.device("cuda")
    return init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) with ``"pod"`` in front."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device)


def make_local_mesh(device=None):
    """(world, 1) ``("data", "model")`` over every rank of the group."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((world, 1), ("data", "model"), device)


def _shape_names(mesh) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if isinstance(mesh, tuple) and len(mesh) == 2:
        shape, names = mesh
        return tuple(int(s) for s in shape), tuple(names)
    if hasattr(mesh, "mesh_dim_names"):          # a DeviceMesh
        return tuple(int(s) for s in mesh.shape), tuple(mesh.mesh_dim_names)
    return tuple(int(s) for s in mesh.devices.shape), tuple(mesh.axis_names)


def axis_names(mesh) -> Tuple[str, ...]:
    return _shape_names(mesh)[1]


def data_axes(mesh) -> tuple:
    """The axes batch data is sharded over (``pod`` folds into ``data``)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def mesh_size(mesh, axis) -> int:
    """Ranks along ``axis`` (a name or a tuple of names); 1 for an axis the
    mesh lacks."""
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh_size(mesh, a) for a in axis)
    shape, names = _shape_names(mesh)
    return shape[names.index(axis)] if axis in names else 1
