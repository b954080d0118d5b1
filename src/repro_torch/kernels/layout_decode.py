"""Decode an Iris-packed bus buffer into per-array piece streams.

Port of the TPU kernels of ``src/repro/kernels/layout_decode.py`` as one
hand-written CUDA source, ``csrc/layout_decode.cu`` (see its header for
what bounds it on an H100 and how its design answers that):

* :func:`decode_layout_fused`, the whole buffer in one launch: every
  ``(row, lane)`` entry of the layout's static slot table funnel-shifts
  one field out of its bus row into a ``(rows, lanes)`` grid
  (:func:`decode_grid`); index gathers then turn the grid into piece
  streams.  Pieces wider than 32 bits (up to 64) are two fields of the
  table, their halves joined after the gather
  (:func:`~repro_torch.core.exec_plan.split_pieces`), so every array
  decodes on the buffer's device.  The reference decodes those arrays
  on the host instead.
* :func:`decode_slot`, one (interval, slot) decode unit per launch: the
  per-slot path of ``ops.decode_layout(fused=False)``.

The wrappers :func:`decode_grid` and :func:`decode_slot` run their plain
versions (``kernels/ref``) for CPU tensors and launch their kernels for
CUDA tensors, or raise; they never fall back.  ``fused_launches`` and
``slot_launches`` count the launches of each.

Bit conventions: bus rows are little-endian u32 words; a piece's LSB sits
at its bit offset and may straddle one word boundary, never a row
boundary, so a two-word funnel shift recovers it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..core.exec_plan import ExecProgram, lower_exec, split_decode_table
from ..core.layout import Layout
from ..device import resolve_device
from . import build
from .ref import U32, words_tensor
from .ref import decode_fused_ref as decode_grid_plain
from .ref import decode_slot_ref as decode_slot_plain

__all__ = ["decode_grid", "decode_grid_plain", "decode_layout_fused",
           "decode_slot", "decode_slot_plain", "fused_launches",
           "slot_launches"]

#: kernel launches made by :func:`decode_grid` / :func:`decode_slot`
fused_launches = 0
slot_launches = 0


def _device_of(*tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    return devs.pop()


def decode_grid(words: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """The fused decode kernel: ``words`` ``(R, W)`` int32-stored u32 bus
    rows, ``tab`` ``(R, L)`` int32 slot table -> ``(R, L)`` int32 grid."""
    global fused_launches
    if words.ndim != 2 or tab.ndim != 2 or words.shape[0] != tab.shape[0]:
        raise ValueError(f"words {tuple(words.shape)} and tab "
                         f"{tuple(tab.shape)} must be (R, W) and (R, L)")
    if words.dtype != torch.int32 or tab.dtype != torch.int32:
        raise ValueError("words and tab must be int32 tensors holding "
                         "uint32 bits")
    dev = _device_of(words, tab)
    if dev.type == "cpu":
        return decode_grid_plain(words, tab)
    if dev.type != "cuda":
        raise ValueError(f"decode_grid runs on cpu or cuda, not {dev}")
    n_rows, lanes = tab.shape
    out = torch.empty((n_rows, lanes), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    words, tab = words.contiguous(), tab.contiguous()
    fn = build.function("layout_decode", "decode_layout_fused_u32",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
    rc = fn(words.data_ptr(), tab.data_ptr(), out.data_ptr(), n_rows, lanes,
            words.shape[1], torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("decode_layout_fused", rc)
    fused_launches += 1
    return out


def decode_slot(rows: torch.Tensor, offsets: torch.Tensor, width: int, *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Decode one (interval, slot) unit: ``len(offsets)`` fields of
    ``width`` bits at the given bit offsets from each of the ``(n_rows,
    W)`` int32-stored u32 ``rows`` (a row slice of a bus buffer).

    Returns ``(n_rows * lanes,)`` int32 codes in stream order, written
    into ``out`` (a contiguous 1-D int32 view) when given.
    """
    global slot_launches
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in [1, 32]; got {width}")
    if rows.ndim != 2 or offsets.ndim != 1:
        raise ValueError(f"rows {tuple(rows.shape)} must be (n_rows, W) and "
                         f"offsets {tuple(offsets.shape)} 1-D")
    if rows.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError("rows and offsets must be int32 tensors")
    n = rows.shape[0] * offsets.shape[0]
    if out is None:
        out = torch.empty((n,), dtype=torch.int32, device=rows.device)
    if out.shape != (n,) or out.dtype != torch.int32 \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous ({n},) int32 tensor")
    dev = _device_of(rows, offsets, out)
    if dev.type == "cpu":
        out.copy_(decode_slot_plain(rows, offsets, width))
        return out
    if dev.type != "cuda":
        raise ValueError(f"decode_slot runs on cpu or cuda, not {dev}")
    if n == 0:
        return out
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    offsets = offsets.contiguous()
    fn = build.function("layout_decode", "decode_slot_u32",
                        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p])
    rc = fn(rows.data_ptr(), rows.stride(0), offsets.data_ptr(),
            out.data_ptr(), rows.shape[0], offsets.shape[0], width,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("decode_slot", rc)
    slot_launches += 1
    return out


def device_decode_tables(prog: ExecProgram, device
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The program's slot table over all its u32 fields (int32) and each
    field's flat grid index (int64) on ``device``
    (:func:`~repro_torch.core.exec_plan.split_decode_table`), built once
    per program and device."""
    device = torch.device(device)
    key = ("decode_tables_device", str(device))
    cached = prog.tables.get(key)
    if cached is None:
        tab, flat = split_decode_table(prog)
        cached = (words_tensor(tab, device),
                  torch.from_numpy(flat).to(device))
        prog.tables[key] = cached
    return cached


def _words32(prog: ExecProgram, buf: torch.Tensor) -> torch.Tensor:
    """``(c_max, m/8)`` uint8 tensor rows -> ``(c_max, words32)``
    int32-stored u32 rows on the same device."""
    if tuple(buf.shape) != (prog.c_max, prog.row_bytes) \
            or buf.dtype != torch.uint8:
        raise ValueError(f"buffer {tuple(buf.shape)} {buf.dtype} != "
                         f"({prog.c_max}, {prog.row_bytes}) uint8")
    pad = prog.words32 * 4 - prog.row_bytes
    return F.pad(buf, (0, pad)).contiguous().view(torch.int32)


def decode_layout_fused(layout: Layout, buf, *,
                        program: ExecProgram | None = None,
                        elem_widths: tuple[int, ...] | None = None,
                        device=None) -> dict[str, torch.Tensor]:
    """Decode the whole packed buffer with one kernel launch.

    ``buf``: the ``(c_max, m/8)`` uint8 buffer, as numpy (sent to
    ``device``, ``"cuda"`` unless given) or as a tensor (decoded on its
    own device).  Returns ``{name: pieces}``, int64 tensors on that
    device holding each piece's bits (a 64-bit piece keeps its top bit
    in the sign).
    """
    prog = program if program is not None \
        else lower_exec(layout, elem_widths)
    if isinstance(buf, torch.Tensor):
        words = _words32(prog, buf)
    else:
        words = words_tensor(
            prog.buffer_words32(np.asarray(buf, dtype=np.uint8)),
            resolve_device(device))
    tab, flat = device_decode_tables(prog, words.device)
    fields = decode_grid(words, tab).reshape(-1)[flat].to(torch.int64) & U32
    outs: dict[str, torch.Tensor] = {}
    hi = prog.n_pieces
    for i, a in enumerate(layout.problem.arrays):
        v = fields[prog.piece_base[i]:prog.piece_base[i + 1]]
        if i in prog.host_arrays:
            n = prog.piece_depths[i]
            v = v | (fields[hi:hi + n] << 32)
            hi += n
        outs[a.name] = v
    return outs
