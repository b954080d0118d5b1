"""Entry points of the layout kernels: ``decode_layout`` and its helpers.

Port of ``src/repro/kernels/ops.py``.  :func:`decode_layout` runs the
accelerator-side read module.  The default (``fused=True``) executes the
compiled :class:`~repro_torch.core.exec_plan.ExecProgram`: one launch of
the fused decode kernel over the whole buffer.  ``fused=False`` runs the
per-(interval, slot) program, one ``decode_slot`` launch per decode unit,
as the reference oracle.  Both run every array on the buffer's device:
a field wider than 32 bits is decoded as two u32 halves (its low 64 bits,
as the reference's host path keeps them), so mixed-width problems decode
end to end on the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.codegen import DecodePlan, decode_plan
from ..core.exec_plan import KERNEL_MAX_WIDTH, ExecProgram
from ..core.layout import Layout
from ..device import resolve_device
from .layout_decode import decode_layout_fused, decode_slot
from .ref import U32


def buffer_to_u32(buf: torch.Tensor) -> torch.Tensor:
    """``(c_max, m/8)`` uint8 rows -> ``(c_max, m/32 + 2)`` int32-stored
    u32 words, little-endian, on the buffer's device.

    Two spare words per row, so a funnel shift at the last element never
    reads past the row (mirrors the packer's spare bytes).
    """
    c, row_bytes = buf.shape
    pad = (-row_bytes) % 4 + 8
    return F.pad(buf.to(torch.uint8), (0, pad)).contiguous().view(
        torch.int32).reshape(c, (row_bytes + pad) // 4)


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
    words = buffer_to_u32(buf)
    # each slot as u32 fields: one of its own width, or for a wider slot
    # the low and high halves of its low 64 bits
    parts = []
    for s in plan.slots:
        base = s.bit_offset + np.arange(s.lanes, dtype=np.int64) * s.width
        if s.width <= KERNEL_MAX_WIDTH:
            parts.append((s, 0, base, s.width))
        else:
            parts.append((s, 0, base, KERNEL_MAX_WIDTH))
            parts.append((s, 1, base + KERNEL_MAX_WIDTH,
                          min(s.width, 64) - KERNEL_MAX_WIDTH))
    halves = {a.name: [torch.zeros(a.depth, dtype=torch.int32,
                                   device=buf.device)
                       for _ in range(1 if a.width <= KERNEL_MAX_WIDTH
                                      else 2)]
              for a in layout.problem.arrays}
    if parts:
        # every field's lane offsets, uploaded once; each launch reads
        # its own slice of them
        offs = torch.from_numpy(np.concatenate(
            [p[2] for p in parts]).astype(np.int32)).to(buf.device)
        at = 0
        for s, half, _base, width in parts:
            n = s.lanes * s.n_cycles
            decode_slot(words[s.start_cycle:s.start_cycle + s.n_cycles],
                        offs[at:at + s.lanes], width,
                        out=halves[s.name][half][s.elem_base:s.elem_base + n])
            at += s.lanes
    out = {}
    for name, hv in halves.items():
        v = hv[0].to(torch.int64) & U32
        if len(hv) == 2:
            v = v | ((hv[1].to(torch.int64) & U32) << 32)
        out[name] = v
    return out
