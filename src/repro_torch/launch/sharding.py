"""Sharding rules: parameter trees and runtime state -> placements.

Port of ``src/repro/launch/sharding.py``.  Strategy:

* TP over 'model' on the "wide" dimension of every weight matrix
  (ffn hidden, attention heads, vocab, experts);
* FSDP over 'data' on the other dimension for large configs;
* DP over ('pod', 'data') for activations / batch;
* EP: expert dimension of MoE weights over 'model';
* every rule is divisibility-checked per tensor dimension — axes that do
  not divide are dropped (replicated) rather than failing, which is what
  lets one rule set serve 10 heterogeneous architectures.  So a DTensor
  placed by these rules never has uneven chunks (:func:`placements`
  asserts it).

A :class:`PartitionSpec` has one entry per tensor dim: ``None``, one
axis name, or a tuple of axis names; it is a tuple, equal entry by entry
to the reference's ``jax.sharding.PartitionSpec``.  A
:class:`NamedSharding` pairs a spec with a mesh — a ``DeviceMesh`` or an
:class:`~repro_torch.launch.mesh.AbstractMesh` (the rules read only the
mesh's shape and axis names).  On a ``DeviceMesh``,
:meth:`NamedSharding.placements` turns it into DTensor placements
(``Shard(d)`` / ``Replicate()`` per mesh dim) and :func:`place` puts a
tree on the mesh as DTensors.

A tensor dim split over two mesh axes (``('pod', 'data')``) is split
over their product with the first axis major, the reference's device
order; DTensor's ``[Shard(d), Shard(d)]`` over mesh dims in the mesh's
order gives the same chunks, so an entry's axes must follow the mesh's
order (:func:`placements` raises otherwise).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from ..pytree import tree_map, tree_map_with_path
from .mesh import axis_names, axis_sizes, dp_axes, mesh_axis_size

# weights whose FIRST data dim is the contraction/output-projection side
_OUT_PROJ = ("wo", "w_o", "w_down", "w_out", "w_v_channel", "decay_b")
# small / replicated leaves
_REPLICATED = ("norm", "scale", "bias", "mix", "bonus_u", "a_log", "d_skip",
               "dt_bias", "decay_w0", "router", "step")


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of axis
    names (a trailing run of None may be left out).  A one-axis tuple is
    kept as its axis, as the reference's ``PartitionSpec`` keeps it."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (``DeviceMesh`` or ``AbstractMesh``)."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The local shard's shape of a tensor of global ``shape``."""
        sizes = axis_sizes(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            for a in _entry_axes(entry):
                out[d] //= sizes[a]
        return tuple(out)

    def placements(self, shape=None) -> tuple:
        """DTensor placements, one per mesh dim (needs torch's DTensor)."""
        return placements(self.spec, self.mesh, shape)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def placements(spec, mesh, shape=None) -> tuple:
    """``spec`` as DTensor placements over ``mesh``'s dims: ``Shard(d)``
    on each mesh dim that an entry ``d`` names, else ``Replicate()``.
    A mesh dim of size 1 is ``Replicate()`` whatever the spec says: its
    one rank holds the whole dim either way, and DTensor's view rules
    refuse some reshapes of a dim sharded even over one rank (torch
    2.11).  With ``shape``, asserts that every sharded dim divides evenly
    (the rules never propose an axis that does not)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    used: set[str] = set()
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} does not follow the "
                             f"mesh's axis order {names}")
        for i in idx:
            if names[i] in used:
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec!r}")
            used.add(names[i])
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
        if shape is not None and axes:
            n = math.prod(sizes[a] for a in axes)
            assert shape[d] % n == 0, (
                f"dim {d} of {tuple(shape)} does not divide over {axes}")
    return tuple(out)


def _fits(dim: int, mesh, axes) -> bool:
    """The axes are all in the mesh and their product divides ``dim`` (a
    mesh without an axis, e.g. a 1-D ``('data',)`` mesh, drops it)."""
    names = axis_names(mesh)
    if any(a not in names for a in ((axes,) if isinstance(axes, str)
                                    else axes)):
        return False
    return dim % mesh_axis_size(mesh, axes) == 0


def _maybe(axis, dim, mesh):
    """axis if it divides dim else None."""
    if axis is None:
        return None
    return axis if _fits(dim, mesh, axis) else None


def _path_str(path) -> str:
    if isinstance(path, str):
        return path.lower()
    return "/".join(str(k) for k in path).lower()


def leaf_partition_spec(path, leaf, mesh, *, fsdp: bool = True
                        ) -> PartitionSpec:
    """PartitionSpec for one param leaf, by name + shape.  ``path``: the
    leaf's keys (a tuple) or their ``/``-joined string."""
    name = _path_str(path)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    stacked = "blocks" in name or "encoder" in name
    fsdp_ax = "data" if (fsdp and "data" in axis_names(mesh)) else None

    def build(dims: tuple) -> PartitionSpec:
        """dims: per-dim axis proposals for the *unstacked* trailing dims."""
        specs = [None] * (len(shape) - len(dims)) + [
            _maybe(a, d, mesh) for a, d in zip(dims, shape[-len(dims):])
        ]
        return P(*specs)

    base = name.rsplit("/", 1)[-1]
    if any(s in base for s in _REPLICATED) or ndim <= 1 + int(stacked):
        return P()
    is_moe = "/moe/" in name or name.endswith("moe")
    core = shape[1:] if stacked else shape
    if is_moe and len(core) == 3:                 # (E, d_in, d_out)
        if any(base.endswith(o) for o in _OUT_PROJ):
            return build(("model", None, fsdp_ax))
        return build(("model", fsdp_ax, None))
    if base == "embed":                           # (V, d) vocab-parallel
        return build(("model", fsdp_ax))
    if base == "unembed":                         # (d, V)
        return build((fsdp_ax, "model"))
    if len(core) == 2:
        if any(base.endswith(o) for o in _OUT_PROJ):
            return build(("model", fsdp_ax))      # contraction on 'model'
        return build((fsdp_ax, "model"))
    return P()


def param_shardings(params_shape: Any, mesh, *, fsdp: bool = True) -> Any:
    """Map a tree of tensors (meta ones too) to NamedShardings."""
    def f(path, leaf):
        return NamedSharding(mesh, leaf_partition_spec(
            path, leaf, mesh, fsdp=fsdp))
    return tree_map_with_path(f, params_shape)


def opt_state_shardings(opt_shape: Any, param_sharding_tree: Any,
                        mesh) -> Any:
    """Moments m/v shard exactly like their params (under the FSDP rule,
    as the reference's do); step is replicated."""
    del param_sharding_tree

    def f(path, leaf):
        if path[0] == "step":
            return NamedSharding(mesh, P())
        # reuse the param rule on the path below m/v
        return NamedSharding(mesh, leaf_partition_spec(path[1:], leaf, mesh))
    return tree_map_with_path(f, opt_shape)


# ----------------------------------------------------------------------
# runtime state (batches, KV caches, decode state)
# ----------------------------------------------------------------------
def batch_sharding(shape_tree: Any, mesh) -> Any:
    """Token batches: leading (global) batch dim over DP axes."""
    dp = dp_axes(mesh)

    def f(_path, leaf):
        if len(leaf.shape) == 0:
            return NamedSharding(mesh, P())
        spec = [None] * len(leaf.shape)
        if _fits(leaf.shape[0], mesh, dp):
            spec[0] = dp
        return NamedSharding(mesh, P(*spec))
    if not isinstance(shape_tree, (dict, list, tuple)):
        return f((), shape_tree)
    return tree_map_with_path(f, shape_tree)


def decode_state_shardings(state_shape: Any, mesh, *,
                           shard_seq: bool = False) -> Any:
    """KV caches: batch over DP (or sequence for long-context, B=1),
    heads over 'model' (falling back to head_dim, then replication)."""
    dp = dp_axes(mesh)

    def kv_spec(shape):
        # (n_periods, B, S, Hkv, hd)
        _np, b, s, hkv, hd = shape
        spec = [None, None, None, None, None]
        if shard_seq:
            if _fits(s, mesh, dp):
                spec[2] = dp
        elif _fits(b, mesh, dp):
            spec[1] = dp
        if _fits(hkv, mesh, "model"):
            spec[3] = "model"
        elif _fits(hd, mesh, "model"):
            spec[4] = "model"
        return P(*spec)

    def f(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if ndim == 0:
            return NamedSharding(mesh, P())
        if "k_cache" in name or "v_cache" in name or "cross_kv" in name:
            return NamedSharding(mesh, kv_spec(shape))
        if "ssm" in name:
            # (np, n_mamba, B, H, n, hd)
            spec = [None] * ndim
            if not shard_seq and _fits(shape[2], mesh, dp):
                spec[2] = dp
            for dim in (3, 4, 5):
                if _fits(shape[dim], mesh, "model"):
                    spec[dim] = "model"
                    break
            return NamedSharding(mesh, P(*spec))
        if "rwkv" in name:
            # (np, B, H, dk, dv)
            spec = [None] * ndim
            if not shard_seq and _fits(shape[1], mesh, dp):
                spec[1] = dp
            for dim in (2, 3, 4):
                if _fits(shape[dim], mesh, "model"):
                    spec[dim] = "model"
                    break
            return NamedSharding(mesh, P(*spec))
        if "shift" in name:
            spec = [None] * ndim
            if not shard_seq and _fits(shape[1], mesh, dp):
                spec[1] = dp
            if _fits(shape[-1], mesh, "model"):
                spec[-1] = "model"
            return NamedSharding(mesh, P(*spec))
        # tokens (B,) / pos ()
        spec = [None] * ndim
        if ndim >= 1 and _fits(shape[0], mesh, dp):
            spec[0] = dp
        return NamedSharding(mesh, P(*spec))
    return tree_map_with_path(f, state_shape)


def shardings_to_specs(tree: Any) -> Any:
    return _map_shardings(lambda s: s.spec, tree)


def _map_shardings(fn, tree):
    from ..tree import PackedTree

    if isinstance(tree, PackedTree):
        return PackedTree(
            packed={k: fn(v) for k, v in tree.packed.items()},
            scales={k: fn(v) for k, v in tree.scales.items()},
            other=tree_map(fn, tree.other),
            streams=None if tree.streams is None else fn(tree.streams),
            manifest=tree.manifest, provenance=tree.provenance)
    return tree_map(fn, tree)


# ----------------------------------------------------------------------
# PackedTree placement
# ----------------------------------------------------------------------
def packed_tree_shardings(pt: Any, mesh) -> Any:
    """NamedShardings for a :class:`repro_torch.tree.PackedTree`, as a
    ``PackedTree`` of the same structure.

    Rules: lane-packed codes and scales are tensor-parallel on the
    output (N) dimension over ``'model'`` when it divides; the unified
    stream buffers shard their layer dimension over the DP axes when it
    divides (each host streams its layers) and replicate otherwise;
    ``other`` leaves follow :func:`leaf_partition_spec` for embeddings
    and replicate the per-layer norm/bias vectors.
    """
    from ..tree import PackedTree

    def tp_n(x) -> NamedSharding:
        # (n_layers, K', N): shard only the last (output) dim
        spec = [None] * (len(x.shape) - 1) + [
            _maybe("model", x.shape[-1], mesh)]
        return NamedSharding(mesh, P(*spec))

    def other_spec(path, leaf) -> NamedSharding:
        base = _path_str(path).rsplit("/", 1)[-1]
        if base in ("embed", "unembed") and len(leaf.shape) >= 2:
            return NamedSharding(
                mesh, leaf_partition_spec(path, leaf, mesh, fsdp=False))
        return NamedSharding(mesh, P())     # norms/biases: replicated

    streams = None
    if pt.streams is not None:
        dp = dp_axes(mesh)
        lead = dp if _fits(pt.streams.shape[0], mesh, dp) else None
        streams = NamedSharding(mesh, P(lead, None, None))
    return PackedTree(
        packed={k: tp_n(v) for k, v in pt.packed.items()},
        scales={k: tp_n(v) for k, v in pt.scales.items()},
        other=tree_map_with_path(other_spec, pt.other),
        streams=streams,
        manifest=pt.manifest,
    )


# ----------------------------------------------------------------------
# placement on a DeviceMesh
# ----------------------------------------------------------------------
def argument_bytes(tree: Any, shardings: Any) -> int:
    """Bytes of one device's shards of ``tree`` (tensors, meta ones
    too) under ``shardings`` (the same structure)."""
    leaves, shards = tree_leaves(tree), tree_leaves(shardings)
    if len(leaves) != len(shards):
        raise ValueError("tree/sharding structure mismatch")
    return sum(math.prod(s.shard_shape(x.shape)) * x.element_size()
               for x, s in zip(leaves, shards))


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree, a ``PackedTree`` too (its ``packed``,
    ``scales``, ``other`` and ``streams``), in ``pytree.flatten`` order."""
    from ..pytree import flatten
    from ..tree import PackedTree

    if isinstance(tree, PackedTree):
        return flatten({"packed": tree.packed, "scales": tree.scales,
                        "other": tree.other, "streams": tree.streams})
    return flatten(tree)


def place_tensor(x, sharding: NamedSharding):
    """``x`` (the whole tensor, the same on every rank) as a DTensor on
    ``sharding``'s ``DeviceMesh``.  A DTensor is moved to the new mesh
    through its full value.  ``x`` must lie on the mesh's device type:
    a tensor is never moved between the host and the card here."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    mesh = sharding.mesh
    if x.device.type != mesh.device_type:
        raise ValueError(f"a {x.device.type} tensor cannot be placed on a "
                         f"{mesh.device_type} mesh: move it first")
    return distribute_tensor(x, mesh,
                             list(sharding.placements(tuple(x.shape))))


def place(tree: Any, shardings: Any) -> Any:
    """Every leaf of ``tree`` as a DTensor placed by the NamedSharding
    at the same place in ``shardings`` (a ``PackedTree`` too)."""
    from ..pytree import unflatten
    from ..tree import PackedTree

    leaves, shards = tree_leaves(tree), tree_leaves(shardings)
    if len(leaves) != len(shards):
        raise ValueError("tree/sharding structure mismatch")
    out = [place_tensor(x, s) for x, s in zip(leaves, shards)]
    if isinstance(tree, PackedTree):
        parts = unflatten({"packed": tree.packed, "scales": tree.scales,
                           "other": tree.other, "streams": tree.streams},
                          out)
        return PackedTree(parts["packed"], parts["scales"], parts["other"],
                          parts["streams"], tree.manifest,
                          provenance=tree.provenance)
    return unflatten(tree, out)
