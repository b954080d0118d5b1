"""Elastic scaling: reshard a training state onto a different mesh.

Port of ``src/repro/runtime/elastic.py``.  Checkpoints are mesh-free
host numpy (``checkpoint/checkpoint.py``), so an elastic rescale is a
restore with the new mesh's shardings.  :func:`reshard_live` is the
in-memory path (a planned shrink or grow without a filesystem round
trip): each leaf's full value (``DTensor.full_tensor()``, a plain tensor
as it is) is placed again with the target sharding.  The reference goes
through host values; the port's collectives stay on the device.

Every rank of the source mesh takes part in the gathers.  A rank
outside the target mesh holds nothing afterwards: its DTensors are
empty, as DTensor makes them.
"""
from __future__ import annotations

from typing import Any

import torch


def reshard_live(tree: Any, new_shardings: Any) -> Any:
    """Re-place every leaf of ``tree`` with the corresponding
    :class:`~repro_torch.launch.sharding.NamedSharding` (a structure
    mismatch raises ``ValueError``)."""
    from ..launch.sharding import place

    return place(tree, new_shardings)


def _full(x) -> torch.Tensor | None:
    """The whole value of a leaf on the host, or None on a rank outside
    its mesh (every rank of the mesh takes part in the gather)."""
    from ..models.shard_utils import is_dtensor, local

    if is_dtensor(x) and x.device_mesh.get_coordinate() is None:
        return None
    return local(x).detach().cpu()


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1)
    return t.view(torch.uint8) if t.is_floating_point() else t


def validate_resharding(old_tree: Any, new_tree: Any) -> None:
    """Bitwise check that a reshard preserved every value (on the ranks
    of the target mesh; the others hold nothing to compare)."""
    from ..launch.sharding import tree_leaves

    for a, b in zip(tree_leaves(old_tree), tree_leaves(new_tree)):
        fa, fb = _full(a), _full(b)
        if fa is None or fb is None:
            continue
        if (fa.shape != fb.shape or fa.dtype != fb.dtype
                or not torch.equal(_bits(fa), _bits(fb))):
            raise AssertionError("resharding changed tensor contents")
