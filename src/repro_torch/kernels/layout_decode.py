"""Decode an Iris-packed bus buffer into per-array piece streams.

Port of the TPU kernels of ``src/repro/kernels/layout_decode.py`` as one
hand-written CUDA source, ``csrc/layout_decode.cu`` (see its header for
what bounds it on an H100 and how its design answers that):

* :func:`decode_layout_fused`, the whole buffer in one launch
  (:func:`decode_pieces`): one thread per piece reads the piece's
  descriptor (:func:`piece_descriptors`: its global bit offset and
  width) and writes the piece straight into one int64 output that holds
  every array back to back; each array is a view of it.  Pieces wider
  than 32 bits (up to 64) are two funnel shifts of the same row, so
  every array decodes on the buffer's device.  The reference decodes
  those arrays on the host instead.  :func:`decode_grid` keeps the TPU
  kernel's literal form: the ``(rows, lanes)`` grid of the static slot
  table (:func:`device_decode_tables`), empty lanes 0.
* The per-slot path of ``ops.decode_layout(fused=False)``, the
  reference's oracle, from the :class:`~repro_torch.core.codegen.
  DecodePlan` alone: every (interval, slot) unit of the plan in one
  launch (:func:`decode_units` over the plan's :class:`UnitTable`).
  :func:`decode_slot` is one unit with free lane offsets.

The wrappers run their plain versions (``kernels/ref``) for CPU tensors
and launch their kernels for CUDA tensors, or raise; they never fall
back.  ``fused_launches`` counts the launches of :func:`decode_grid` and
:func:`decode_pieces`, ``slot_launches`` those of :func:`decode_slot`
and :func:`decode_units`.

Bit conventions: bus rows are little-endian u32 words; a piece's LSB sits
at its bit offset and may straddle one word boundary, never a row
boundary, so a two-word funnel shift recovers it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.codegen import DecodePlan
from ..core.exec_plan import KERNEL_MAX_WIDTH, ExecProgram, lower_exec, \
    split_decode_table
from ..core.layout import Layout
from ..core.task import LayoutProblem
from ..device import resolve_device
from . import build
from .ref import decode_fused_ref as decode_grid_plain
from .ref import decode_pieces_ref as decode_pieces_plain
from .ref import decode_slot_ref as decode_slot_plain
from .ref import decode_units_ref, words_tensor

__all__ = ["UnitTable", "decode_grid", "decode_grid_plain",
           "decode_layout_fused", "decode_pieces", "decode_pieces_plain",
           "decode_slot", "decode_slot_plain", "decode_units",
           "decode_units_plain", "device_decode_tables",
           "device_piece_table", "device_unit_table", "fused_launches",
           "piece_descriptors", "rows_u32", "slot_launches", "unit_table"]

#: kernel launches of the fused decode (:func:`decode_grid`,
#: :func:`decode_pieces`) and of the per-slot decode (:func:`decode_slot`,
#: :func:`decode_units`)
fused_launches = 0
slot_launches = 0

#: a piece descriptor is ``global bit offset << 6 | (width - 1)``; it
#: fits 32 bits while every offset is below 2^26
_DESC_SHIFT = 6
_THREADS = 256
#: blocks of the per-slot kernel an SM (tools/sweep_decode_units.py)
_UNIT_BLOCKS_PER_SM = 16
#: the per-slot kernel indexes fields and elements with int32
_INT32_LIMIT = (1 << 31) - (1 << 24)


def _device_of(*tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    return devs.pop()


def _cuda_or_raise(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")


def decode_grid(words: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """The fused decode in the TPU kernel's form: ``words`` ``(R, W)``
    int32-stored u32 bus rows, ``tab`` ``(R, L)`` int32 slot table ->
    ``(R, L)`` int32 grid."""
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
    _cuda_or_raise(dev, "decode_grid")
    n_rows, lanes = tab.shape
    out = torch.empty((n_rows, lanes), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    words, tab = words.contiguous(), tab.contiguous()
    fn = build.function("layout_decode", "decode_grid_u32",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
    rc = fn(words.data_ptr(), tab.data_ptr(), out.data_ptr(), n_rows, lanes,
            words.shape[1], build.stream_handle(dev))
    build.check_launch("decode_grid", rc)
    fused_launches += 1
    return out


def decode_pieces(words: torch.Tensor, desc: torch.Tensor) -> torch.Tensor:
    """The fused decode kernel: ``words`` ``(R, W)`` int32-stored u32 bus
    rows, ``desc`` ``(P,)`` piece descriptors (int32 holding u32 bits, or
    int64; :func:`piece_descriptors`) -> ``(P,)`` int64 pieces."""
    global fused_launches
    if words.ndim != 2 or desc.ndim != 1:
        raise ValueError(f"words {tuple(words.shape)} and desc "
                         f"{tuple(desc.shape)} must be (R, W) and (P,)")
    if words.dtype != torch.int32 \
            or desc.dtype not in (torch.int32, torch.int64):
        raise ValueError("words must be int32 holding uint32 bits and desc "
                         "int32 or int64")
    dev = _device_of(words, desc)
    if dev.type == "cpu":
        return decode_pieces_plain(words, desc)
    _cuda_or_raise(dev, "decode_pieces")
    out = torch.empty(desc.shape[0], dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    words, desc = words.contiguous(), desc.contiguous()
    if desc.data_ptr() % 16:            # the kernel loads 16 bytes at once
        desc = desc.clone()
    fn = build.function("layout_decode", "decode_pieces_u64",
                        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_void_p])
    rc = fn(words.data_ptr(), words.numel(), desc.data_ptr(),
            desc.element_size(), out.data_ptr(), out.numel(),
            build.stream_handle(dev))
    build.check_launch("decode_pieces", rc)
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
    _cuda_or_raise(dev, "decode_slot")
    if n == 0:
        return out
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    offsets = offsets.contiguous()
    fn = build.function("layout_decode", "decode_slot_u32",
                        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(rows.data_ptr(), rows.stride(0), rows.shape[1],
            offsets.data_ptr(), out.data_ptr(), rows.shape[0],
            offsets.shape[0], width, build.stream_handle(dev))
    build.check_launch("decode_slot", rc)
    slot_launches += 1
    return out


# ----------------------------------------------------------------------
# the per-slot decode of a whole plan
# ----------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class UnitTable:
    """Every (interval, slot) unit of a decode plan, for one launch.

    A slot of at most 32 bits is one unit; a wider one (up to 64 bits;
    a wider slot keeps its low 64) is two, its low and its high u32
    word.  The int64 output holds the problem's arrays back to back.
    """

    #: ``(U, 8)`` int32 rows ``(row0, lanes, first, pitch, width, kind,
    #: base, n_cycles)`` (``csrc/layout_decode.cu`` ``Unit``)
    units: torch.Tensor
    prefix: torch.Tensor            # (U + 1,) int32 field prefix sums
    n_fields: int
    bases: tuple[int, ...]          # each array's first element, + total
    depths: tuple[int, ...]         # elements per array
    covers_all: bool                # every element is some unit's field
    n_rows: int                     # bus rows the units read
    n_bits: int                     # bits of a row the units read

    @property
    def n_out(self) -> int:
        return self.bases[-1]

    def to(self, device) -> UnitTable:
        return dataclasses.replace(self, units=self.units.to(device),
                                   prefix=self.prefix.to(device))


def _tiles(spans: list[tuple[int, int, int]], depths: list[int]) -> bool:
    """Whether the ``(array, start, end)`` spans tile every array's
    ``[0, depth)`` once, without gap or overlap."""
    at = [0] * len(depths)
    for i, lo, hi in sorted(spans):
        if lo != at[i]:
            return False
        at[i] = hi
    return at == depths


def unit_table(plan: DecodePlan, problem: LayoutProblem) -> UnitTable:
    """The :class:`UnitTable` of ``plan`` over ``problem``'s arrays, on
    the CPU; slots without fields are left out.  Raises where a slot runs
    past its array or the kernel's int32 indices."""
    depths = [a.depth for a in problem.arrays]
    bases = (0, *np.cumsum(depths, dtype=np.int64).tolist())
    rows, spans = [], []
    for s in plan.slots:
        n = s.lanes * s.n_cycles
        if n == 0:
            continue
        if s.elem_base < 0 or s.elem_base + n > depths[s.array]:
            raise ValueError(
                f"slot of {s.name} covers elements [{s.elem_base}, "
                f"{s.elem_base + n}) of {depths[s.array]}")
        base = bases[s.array] + s.elem_base
        spans.append((s.array, s.elem_base, s.elem_base + n))
        head = (s.start_cycle, s.lanes)
        if s.width <= KERNEL_MAX_WIDTH:
            rows.append((*head, s.bit_offset, s.width, s.width, 0, base,
                         s.n_cycles))
        else:
            rows.append((*head, s.bit_offset, s.width, KERNEL_MAX_WIDTH, 1,
                         base, s.n_cycles))
            rows.append((*head, s.bit_offset + KERNEL_MAX_WIDTH, s.width,
                         min(s.width, 64) - KERNEL_MAX_WIDTH, 2, base,
                         s.n_cycles))
    units = np.asarray(rows, dtype=np.int64).reshape(-1, 8)
    prefix = np.concatenate([[0], np.cumsum(units[:, 1] * units[:, 7])])
    n_rows = int((units[:, 0] + units[:, 7]).max()) if units.size else 0
    n_bits = int((units[:, 2] + (units[:, 1] - 1) * units[:, 3]
                  + units[:, 4]).max()) if units.size else 0
    if max(int(prefix[-1]), bases[-1], n_bits) >= _INT32_LIMIT:
        raise ValueError("the plan's fields, elements or row bits exceed "
                         "the per-slot kernel's int32 indices")
    return UnitTable(
        units=torch.from_numpy(units.astype(np.int32)),
        prefix=torch.from_numpy(prefix.astype(np.int32)),
        n_fields=int(prefix[-1]), bases=tuple(int(b) for b in bases),
        depths=tuple(depths), covers_all=_tiles(spans, depths),
        n_rows=n_rows, n_bits=n_bits)


def device_unit_table(plan: DecodePlan, problem: LayoutProblem,
                      device) -> UnitTable:
    """:func:`unit_table` on ``device``, built once per plan and device:
    memoized on the plan (a frozen dataclass, so in its ``__dict__``,
    outside its fields)."""
    device = torch.device(device)
    memo = plan.__dict__.setdefault("_unit_tables", {})
    table = memo.get(str(device))
    if table is None or table.depths != tuple(a.depth
                                               for a in problem.arrays):
        table = unit_table(plan, problem).to(device)
        memo[str(device)] = table
    return table


def decode_units_plain(words: torch.Tensor, table: UnitTable
                       ) -> torch.Tensor:
    """Plain version of :func:`decode_units`."""
    return decode_units_ref(words, table.units, table.prefix, table.n_out)


def decode_units(words: torch.Tensor, table: UnitTable) -> torch.Tensor:
    """The per-slot decode kernel over a whole plan: ``words`` ``(R, W)``
    int32-stored u32 bus rows -> the ``(table.n_out,)`` int64 elements of
    every array, back to back (``table.bases``); elements no unit covers
    read 0."""
    global slot_launches
    if words.ndim != 2 or words.dtype != torch.int32:
        raise ValueError(f"words {tuple(words.shape)} {words.dtype} must be "
                         "(R, W) int32 holding uint32 bits")
    if words.shape[0] < table.n_rows or words.shape[1] * 32 < table.n_bits:
        raise ValueError(f"words {tuple(words.shape)} hold fewer rows or "
                         f"bits than the units read ({table.n_rows} rows, "
                         f"{table.n_bits} bits)")
    dev = _device_of(words, table.units, table.prefix)
    if dev.type == "cpu":
        return decode_units_plain(words, table)
    _cuda_or_raise(dev, "decode_units")
    make = torch.empty if table.covers_all else torch.zeros
    out = make(table.n_out, dtype=torch.int64, device=dev)
    if table.n_fields == 0:
        return out
    words = words.contiguous()
    # a block walks one contiguous chunk of fields; the grid fills the card
    blocks = min(-(-table.n_fields // _THREADS),
                 build.device_sms(dev) * _UNIT_BLOCKS_PER_SM)
    chunk = -(-table.n_fields // (blocks * _THREADS)) * _THREADS
    fn = build.function("layout_decode", "decode_units_u32",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(words.data_ptr(), words.shape[1], table.units.data_ptr(),
            table.prefix.data_ptr(), table.units.shape[0], out.data_ptr(),
            table.n_fields, chunk, build.stream_handle(dev))
    build.check_launch("decode_units", rc)
    slot_launches += 1
    return out


# ----------------------------------------------------------------------
# the fused decode of a lowered program
# ----------------------------------------------------------------------
def device_decode_tables(prog: ExecProgram, device
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The program's slot table over all its u32 fields (int32) and each
    field's flat grid index (int64) on ``device``
    (:func:`~repro_torch.core.exec_plan.split_decode_table`), built once
    per program and device: :func:`decode_grid`'s table."""
    device = torch.device(device)
    key = ("decode_tables_device", str(device))
    cached = prog.tables.get(key)
    if cached is None:
        tab, flat = split_decode_table(prog)
        cached = (words_tensor(tab, device),
                  torch.from_numpy(flat).to(device))
        prog.tables[key] = cached
    return cached


def piece_descriptors(prog: ExecProgram) -> np.ndarray:
    """One descriptor per piece, in global piece order: its global bit
    offset in the :meth:`~ExecProgram.buffer_words32` rows, flattened,
    ``<< 6 | (width - 1)``.  uint32 when every offset is below 2^26 - 64
    (one int3 smollm-135m layer: 12.4 Mbit), else uint64.  Memoized on
    the program."""
    key = "piece_descriptors"
    cached = prog.tables.get(key)
    if cached is not None:
        return cached
    if any(w > 64 for w in prog.elem_widths):
        raise ValueError(f"piece widths {prog.elem_widths}: the kernels "
                         "take pieces of at most 64 bits")
    word = prog.word.astype(np.int64)
    if prog.words32 == 2 * prog.wpr:    # a row is as long in both views
        off = word * 64
    else:
        row, col = np.divmod(word, prog.wpr)
        off = row * (prog.words32 * 32) + col * 64
    off += prog.shift
    width = np.repeat(np.asarray(prog.elem_widths, dtype=np.int64),
                      prog.piece_depths)
    last = int(off.max()) + 64 if off.size else 0
    if last > (1 << 32):
        raise ValueError("stream exceeds the 2^32-bit addressing range of "
                         "the piece descriptors")
    off <<= _DESC_SHIFT
    off |= width - 1
    small = last <= (1 << 26)
    desc = off.astype(np.uint32 if small else np.uint64)
    prog.tables[key] = desc
    return desc


def device_piece_table(prog: ExecProgram, device) -> torch.Tensor:
    """:func:`piece_descriptors` on ``device`` (int32 or int64 holding
    their bits), built once per program and device."""
    device = torch.device(device)
    key = ("decode_pieces_device", str(device))
    cached = prog.tables.get(key)
    if cached is None:
        desc = piece_descriptors(prog)
        signed = np.int32 if desc.dtype == np.uint32 else np.int64
        cached = torch.from_numpy(desc.view(signed).copy()).to(device)
        prog.tables[key] = cached
    return cached


def rows_u32(buf: torch.Tensor) -> torch.Tensor:
    """``(R, B)`` uint8 rows -> ``(R, ceil(B / 4))`` int32-stored u32
    rows, little-endian, on the same device: a view where the rows are
    whole, aligned words, else a copy padded with zero bytes."""
    pad = -buf.shape[1] % 4
    if pad == 0 and buf.is_contiguous() and buf.storage_offset() % 4 == 0:
        return buf.view(torch.int32)
    return F.pad(buf, (0, pad)).contiguous().view(torch.int32)


def decode_layout_fused(layout: Layout, buf, *,
                        program: ExecProgram | None = None,
                        elem_widths: tuple[int, ...] | None = None,
                        device=None) -> dict[str, torch.Tensor]:
    """Decode the whole packed buffer with one kernel launch.

    ``buf``: the ``(c_max, m/8)`` uint8 buffer, as numpy (sent to
    ``device``, ``"cuda"`` unless given) or as a tensor (decoded on its
    own device).  Returns ``{name: pieces}``, int64 views of one output
    on that device holding each piece's bits (a 64-bit piece keeps its
    top bit in the sign).
    """
    prog = program if program is not None \
        else lower_exec(layout, elem_widths)
    if isinstance(buf, torch.Tensor):
        if tuple(buf.shape) != (prog.c_max, prog.row_bytes) \
                or buf.dtype != torch.uint8:
            raise ValueError(f"buffer {tuple(buf.shape)} {buf.dtype} != "
                             f"({prog.c_max}, {prog.row_bytes}) uint8")
        words = rows_u32(buf)
    else:
        words = words_tensor(
            prog.buffer_words32(np.asarray(buf, dtype=np.uint8)),
            resolve_device(device))
    flat = decode_pieces(words, device_piece_table(prog, words.device))
    return {a.name: flat[prog.piece_base[i]:prog.piece_base[i + 1]]
            for i, a in enumerate(layout.problem.arrays)}
