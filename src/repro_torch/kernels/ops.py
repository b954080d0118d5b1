"""Entry points of the layout kernels: ``decode_layout`` and its helpers.

Port of ``src/repro/kernels/ops.py``.  :func:`decode_layout` runs the
accelerator-side read module.  The default (``fused=True``) executes the
compiled :class:`~repro_torch.core.exec_plan.ExecProgram`: one launch of
the fused decode kernel over the whole buffer.  ``fused=False`` runs the
per-(interval, slot) program of the :class:`DecodePlan`, every decode
unit in one launch of the per-slot kernel, as the reference oracle.
Both run every array on the buffer's device: a field wider than 32 bits
is decoded as two u32 halves (its low 64 bits, as the reference's host
path keeps them), so mixed-width problems decode end to end on the
card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.codegen import DecodePlan, decode_plan
from ..core.exec_plan import ExecProgram
from ..core.layout import Layout
from ..device import resolve_device
from .layout_decode import decode_layout_fused, decode_units, \
    device_unit_table, rows_u32


def buffer_to_u32(buf: torch.Tensor) -> torch.Tensor:
    """``(c_max, m/8)`` uint8 rows -> ``(c_max, m/32 + 2)`` int32-stored
    u32 words, little-endian, on the buffer's device.

    :func:`~repro_torch.kernels.layout_decode.rows_u32` with two spare
    words per row, so a funnel shift at the last element never reads past
    the row (mirrors the packer's spare bytes).
    """
    return F.pad(rows_u32(buf.to(torch.uint8)), (0, 2))


def decode_layout(layout: Layout, buf_u8, *,
                  plan: DecodePlan | None = None,
                  fused: bool | None = None,
                  program: ExecProgram | None = None,
                  device=None) -> dict:
    """Decode an Iris-packed buffer into per-array code streams.

    ``fused=None`` resolves to the fused single-kernel path unless a
    per-slot ``plan`` is supplied.  Passing both ``fused=True`` and
    ``plan`` raises.  ``buf_u8`` is numpy (sent to ``device``, ``"cuda"``
    unless given) or a uint8 tensor (decoded on its own device).  Returns
    int64 tensors on that device holding each code's bits (the per-slot
    path keeps the low 64 bits of a wider field).
    """
    if fused and plan is not None:
        raise ValueError(
            "plan= belongs to the per-slot path; pass program= (or "
            "nothing) for the fused path"
        )
    if fused is None:
        fused = plan is None
    if fused:
        return decode_layout_fused(layout, buf_u8, program=program,
                                   device=device)
    plan = plan if plan is not None else decode_plan(layout)
    if isinstance(buf_u8, torch.Tensor):
        buf = buf_u8
    else:
        buf = torch.from_numpy(np.ascontiguousarray(buf_u8, np.uint8)).to(
            resolve_device(device))
    table = device_unit_table(plan, layout.problem, buf.device)
    flat = decode_units(rows_u32(buf.to(torch.uint8)), table)
    return {a.name: flat[table.bases[i]:table.bases[i + 1]]
            for i, a in enumerate(layout.problem.arrays)}
