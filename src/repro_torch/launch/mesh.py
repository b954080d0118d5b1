"""Production meshes.

Port of ``src/repro/launch/mesh.py``.  Single pod: 256 cards as
(data=16, model=16).  Multi-pod: 2 pods x 256 cards as (pod=2, data=16,
model=16); the ``'pod'`` axis carries pure data parallelism.

Two kinds of mesh:

* a :class:`~torch.distributed.device_mesh.DeviceMesh`, over the ranks
  of an initialised process group, where tensors are placed as DTensors
  (``make_production_mesh``, ``make_debug_mesh``);
* an :class:`AbstractMesh`: a shape and axis names, no process group.
  The sharding rules (``launch/sharding.py``) and the dry run
  (``launch/dryrun.py``) read only the shape and the axis names, as the
  reference's do, so they take either kind.

Rank ``i`` of a mesh is the reference's ``jax.devices()[i]``: both lay
the first ``n`` devices out row-major over the mesh's shape.
"""
from __future__ import annotations

import math
from collections import OrderedDict


class AbstractMesh:
    """A mesh's shape and axis names, with no devices behind them."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             "in length")
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, map(int, shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"AbstractMesh({dims})"


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of either kind of mesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's order, for either kind of mesh."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def _device_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                 device_type: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks, have {world}: initialise a process group of "
            f"at least {n} ranks first (torch.distributed."
            "init_process_group)")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         abstract_only: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) or (2, 16, 16) production mesh: a ``DeviceMesh`` over
    the process group's first 256 / 512 ranks (it raises when the group
    is smaller, as the reference raises when there are too few
    devices), or with ``abstract_only`` an :class:`AbstractMesh`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if abstract_only:
        return AbstractMesh(shape, axes)
    return _device_mesh(shape, axes, device_type)


def make_debug_mesh(shape: tuple[int, ...] = (2, 2),
                    axes: tuple[str, ...] = ("data", "model"), *,
                    device_type: str | None = None):
    """Small ``DeviceMesh`` for tests (the process group must have at
    least ``prod(shape)`` ranks), on ``"cuda"`` unless the caller passes
    ``device_type="cpu"`` (``device.resolve_device``)."""
    from ..device import resolve_device

    return _device_mesh(tuple(shape), tuple(axes),
                        resolve_device(device_type).type)


def dp_axes(mesh) -> tuple[str, ...]:
    """The pure data-parallel axes of a mesh ('pod' folds into DP)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def mesh_axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    out = 1
    for a in axes:
        out *= sizes[a]
    return out
