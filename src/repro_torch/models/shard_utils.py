"""Activation sharding constraints that degrade gracefully.

Port of ``src/repro/models/shard_utils.py``.  ``maybe_shard(x, *spec)``
redistributes a DTensor to ``spec`` iff a mesh is active; each axis is
divisibility-checked against its dim and dropped when it doesn't fit.
Model code can therefore annotate its activations unconditionally —
runs without a mesh (and plain tensors) go through unchanged, the same
object, and every arch (heterogeneous dims) runs the same code path.

A mesh is made active by :func:`use_mesh`, the counterpart of the
reference's ``with mesh:``.  It is thread-local and restored on exit,
also on an exception.  With a ``DeviceMesh`` active, plain tensors that
meet DTensors in one op are treated as replicated (DTensor's
``implicit_replication``): positions, masks and the zeros the model
makes itself.

The explicit gathers the port makes where DTensor has no working rule
for an op (each call site says which): :func:`unshard` (chosen dims
replicated), :func:`local` (the whole value as a plain tensor, for the
ctypes kernels), :func:`split_heads` (a head split that does not
divide its shards) and :func:`gather_grad` (the same for a gradient).
:func:`local_rows` and :func:`rows_like` hand a rank's own rows of a
DP-sharded batch to per-row work and back, with no collective.  Each is
the identity on a plain tensor.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def active_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` or an ``AbstractMesh``) the
    active mesh of this thread for the block."""
    from ..launch.mesh import AbstractMesh

    prev = active_mesh()
    _state.mesh = mesh
    try:
        if isinstance(mesh, AbstractMesh):
            yield mesh
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication,
            )
            with implicit_replication():
                yield mesh
    finally:
        _state.mesh = prev


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def maybe_shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """spec: one entry per dim — None, 'axis', or ('ax1', 'ax2')."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    from ..launch.mesh import axis_names, axis_sizes
    from ..launch.sharding import P, placements

    names, sizes = axis_names(mesh), axis_sizes(mesh)
    fixed = []
    for dim, ax in zip(x.shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a in names)
        size = 1
        for a in axes:
            size *= sizes[a]
        if axes and size > 0 and dim % size == 0:
            fixed.append(axes if len(axes) > 1 else axes[0])
        else:
            fixed.append(None)
    want = placements(P(*fixed), x.device_mesh, tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def dp_spec() -> tuple:
    """The data-parallel axis group for activation batch dims."""
    mesh = active_mesh()
    if mesh is None:
        return ("data",)
    from ..launch.mesh import dp_axes

    return dp_axes(mesh)


def unshard(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """A DTensor with tensor dims ``dims`` (all dims if none are given)
    gathered whole on every rank; other placements are kept.  A plain
    tensor is returned unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % x.ndim for d in dims} if dims else set(range(x.ndim))
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims
                 else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def local(x):
    """The whole value of ``x`` as a plain tensor on this rank: a DTensor
    is gathered (every placement made replicated), a plain tensor comes
    back as it is.  The port's CUDA kernels take plain tensors."""
    if not is_dtensor(x):
        return x
    if x.device_mesh.size() == 1 or all(p.is_replicate()
                                        for p in x.placements):
        return x.to_local()             # already whole: no collective
    return x.full_tensor()


def local_rows(x):
    """This rank's block of rows of ``x`` as a plain tensor: the local
    tensor of a DTensor whose only sharded dim is dim 0 (the batch over
    the DP axes), no collective; a plain tensor as it is.  For per-row
    work that DTensor has no rule for (MoE's integer-indexed dispatch
    and combine)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    if not all(p.is_replicate() or (isinstance(p, Shard) and p.dim == 0)
               for p in x.placements):
        raise ValueError(f"not a row-sharded DTensor: {x.placements}")
    return x.to_local()


def rows_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t``, this rank's block of rows (:func:`local_rows` of ``ref``),
    as a DTensor placed as ``ref`` is; ``t`` itself when ``ref`` is a
    plain tensor."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False)


def split_heads(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)`` where x's last dim splits into the last two
    of ``shape`` (heads, head width).  Explicit gather: DTensor refuses
    a split whose heads do not divide over the ranks that shard the
    last dim (GQA with fewer KV heads than the 'model' axis), so such a
    DTensor is gathered on that dim first."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard

        n = 1
        for size, p in zip(x.device_mesh.shape, x.placements):
            if isinstance(p, Shard) and p.dim == x.ndim - 1:
                n *= size
        if shape[-2] % n:
            x = unshard(x, -1)
    return x.reshape(*shape)


class _GatherGrad(torch.autograd.Function):
    """Identity forward; the backward gathers the gradient's ``dim``."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return unshard(g, ctx.dim), None


def gather_grad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``, whose gradient arrives with ``dim`` gathered whole (for an
    op before it whose backward cannot take that dim sharded).  The
    identity, without a node, on a plain tensor."""
    if not is_dtensor(x):
        return x
    return _GatherGrad.apply(x, dim)
