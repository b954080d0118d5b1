"""Small shared helpers of the port's layout core.

Own copy of ``src/repro/core/util.py``: the ceiling round-up and the
bundle element-padding step that meets the compiled pack program.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - type-only imports
    from .exec_plan import ExecProgram
    from .task import LayoutProblem

__all__ = ["round_up", "pad_bundle_elements"]


def round_up(x: int, to: int) -> int:
    """Smallest multiple of ``to`` that is >= ``x`` (``to`` > 0)."""
    if to <= 0:
        raise ValueError(f"round_up: 'to' must be positive, got {to}")
    return -(-x // to) * to


def pad_bundle_elements(prob: "LayoutProblem", prog: "ExecProgram",
                        data: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Flatten + zero-pad per-tensor element data up to whole scheduling
    units (``prog.piece_depths``), ready for
    :func:`repro_torch.core.exec_plan.pack_compiled`."""
    padded: dict[str, np.ndarray] = {}
    for i, spec in enumerate(prob.arrays):
        vals = np.asarray(data[spec.name]).reshape(-1).astype(np.uint64)
        pad = prog.piece_depths[i] - vals.shape[0]
        if pad < 0:
            raise ValueError(
                f"{spec.name}: {vals.shape[0]} elements exceed the "
                f"scheduled capacity {prog.piece_depths[i]}"
            )
        if pad:
            vals = np.pad(vals, (0, pad))
        padded[spec.name] = vals
    return padded
