"""``pack_layout_fused``: pack per-array piece streams into an Iris bus buffer.

Port of the TPU kernel ``src/repro/kernels/layout_pack.py:pack_layout_fused``
as hand-written CUDA kernels in ``csrc/layout_pack.cu`` (see its header
for what bounds them on an H100 and how their design answers that):

* :func:`pack_pieces`, a layer's whole pack in one launch
  (:func:`pack_runs`): each thread owns a destination u32 word of a bus
  row and ORs in every piece that overlaps it, read straight from its
  array's own tensor (uint8, int16, int32 or int64) through the
  program's run table (:func:`pack_run_table`: runs of consecutive pieces
  of one array laid side by side in one row).  Pieces of up to 64 bits
  go in whole.  ``tree.pack_tree`` packs every layer with it;
  :func:`pack_layout_fused` is the layout-level entry point over numpy
  streams, byte-equal to :func:`~repro_torch.core.exec_plan.pack_compiled`.
  The reference packs the arrays wider than 32 bits on the host instead.
* :func:`pack_words` keeps the TPU kernel's literal form: every
  destination word the OR of at most K gathered, shifted fields of a flat
  u32 piece stream, through gather-only contribution tables
  (:func:`device_pack_tables`,
  :func:`~repro_torch.core.exec_plan.split_pack_tables`).

The wrappers run their plain versions (``kernels/ref``:
:func:`pack_runs_plain`, :func:`pack_words_plain`) for CPU tensors and
launch their kernels on the current stream for CUDA tensors, or raise;
they never fall back.  ``launches`` counts the launches of both.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.exec_plan import ExecProgram, lower_exec, split_pack_tables
from ..core.layout import Layout
from ..device import resolve_device
from . import build
from .ref import pack_fused_ref as pack_words_plain
from .ref import pack_runs_plain

__all__ = ["PackRuns", "device_pack_runs", "device_pack_tables",
           "launches", "pack_layout_fused", "pack_pieces", "pack_run_table",
           "pack_runs", "pack_runs_plain", "pack_words", "pack_words_plain"]

#: kernel launches made by :func:`pack_runs` and :func:`pack_words`
launches = 0


def pack_words(flat: torch.Tensor, src: torch.Tensor,
               scode: torch.Tensor) -> torch.Tensor:
    """OR-assemble packed u32 words from the flat piece stream.

    ``flat``: ``(P + 1,)`` int32-stored u32 pieces, 0 sentinel at [0];
    ``src`` / ``scode``: ``(K, n_words)`` int32 contribution tables
    (:func:`device_pack_tables`).  Returns ``(n_words,)`` int32 words.
    """
    global launches
    if src.shape != scode.shape or src.ndim != 2:
        raise ValueError(f"src {tuple(src.shape)} and scode "
                         f"{tuple(scode.shape)} must be one (K, n) shape")
    if flat.ndim != 1:
        raise ValueError(f"flat must be 1-D, got {tuple(flat.shape)}")
    if not all(t.dtype == torch.int32 for t in (flat, src, scode)):
        raise ValueError("flat, src and scode must be int32 tensors")
    devs = {t.device for t in (flat, src, scode)}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    if flat.device.type == "cpu":
        return pack_words_plain(flat, src, scode)
    if flat.device.type != "cuda":
        raise ValueError(f"pack_words runs on cpu or cuda, not {flat.device}")
    k, n_words = src.shape
    out = torch.empty((n_words,), dtype=torch.int32, device=flat.device)
    if n_words == 0:
        return out
    flat, src, scode = flat.contiguous(), src.contiguous(), scode.contiguous()
    fn = build.function("layout_pack", "pack_layout_fused_u32",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_void_p])
    rc = fn(flat.data_ptr(), src.data_ptr(), scode.data_ptr(),
            out.data_ptr(), n_words, k,
            torch.cuda.current_stream(flat.device).cuda_stream)
    build.check_launch("pack_layout_fused", rc)
    launches += 1
    return out


def device_pack_tables(prog: ExecProgram, device
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`~repro_torch.core.exec_plan.split_pack_tables` transposed to
    ``(K, c_max * words32)`` int32 on ``device``, so that the k-th
    contributions of neighbouring words lie side by side.  Built once per
    program and device (every rebind of the layout shares it)."""
    device = torch.device(device)
    key = ("pack_tables_device", str(device))
    cached = prog.tables.get(key)
    if cached is None:
        src, scode, k = split_pack_tables(prog)
        n_words = prog.c_max * prog.words32

        def kmajor(t: np.ndarray) -> torch.Tensor:
            t = t.reshape(n_words, k).T if n_words else \
                np.zeros((k, 0), np.int32)
            return torch.from_numpy(np.ascontiguousarray(t)).to(device)

        cached = (kmajor(src), kmajor(scode))
        prog.tables[key] = cached
    return cached


@dataclasses.dataclass(eq=False)
class PackRuns:
    """A program's run table: where every piece goes, one entry a run.

    A run is ``count`` consecutive pieces of one array, each ``width``
    bits, laid side by side in one bus row.  ``runs`` is sorted by row,
    then by first bit, and ``row_start`` indexes it by row (CSR).
    """

    #: ``(R, 6)`` int32 rows ``(array, first piece, row, first bit, width,
    #: count)`` (``csrc/layout_pack.cu`` ``Run``)
    runs: torch.Tensor
    row_start: torch.Tensor         # (c_max + 1,) int32
    c_max: int
    words32: int                    # u32 words per bus row

    def to(self, device) -> PackRuns:
        return dataclasses.replace(self, runs=self.runs.to(device),
                                   row_start=self.row_start.to(device))


#: the kernel indexes pieces, rows and row bits with int32
_INT32_LIMIT = 1 << 31
#: the kernel takes each array's pointer, length and element type as
#: kernel arguments: at most this many arrays
MAX_ARRAYS = 1024
#: the stream types the kernel reads, by element size (the signed ones
#: sign-extended, as ``.to(torch.int64)`` does)
_KINDS = {torch.uint8: 1, torch.int16: 2, torch.int32: 4, torch.int64: 8}


def pack_run_table(prog: ExecProgram) -> PackRuns:
    """The run table of ``prog``, on the CPU, from the pieces' destination
    words and shifts (``prog.word``, ``prog.shift``), in the program's
    global piece order.  Raises on a piece the kernel cannot take: wider
    than 64 bits or crossing the end of its row.  Memoized on the
    program."""
    key = ("pack_runs", "cpu")
    cached = prog.tables.get(key)
    if cached is not None:
        return cached
    if any(not 1 <= w <= 64 for w in prog.elem_widths):
        raise ValueError(f"piece widths {prog.elem_widths}: the pack kernel "
                         "takes pieces of 1 to 64 bits")
    n = prog.n_pieces
    if n >= _INT32_LIMIT or prog.c_max >= _INT32_LIMIT \
            or prog.words32 * 32 >= _INT32_LIMIT:
        raise ValueError("the program's pieces, rows or row bits exceed the "
                         "pack kernel's int32 indices")
    word = prog.word.astype(np.int64)
    row, col = np.divmod(word, prog.wpr)
    bit = col * 64 + prog.shift.astype(np.int64)
    width = np.repeat(np.asarray(prog.elem_widths, dtype=np.int64),
                      prog.piece_depths)
    array = np.repeat(np.arange(len(prog.piece_depths)), prog.piece_depths)
    if n and int((bit + width).max()) > prog.words32 * 32:
        raise ValueError("a piece crosses the end of its bus row")
    # a run breaks where the array or the row changes, or a piece does not
    # start where the one before it ends
    new = np.ones(n, dtype=bool)
    new[1:] = (array[1:] != array[:-1]) | (row[1:] != row[:-1]) \
        | (bit[1:] != bit[:-1] + width[:-1])
    first = np.flatnonzero(new)
    count = np.diff(np.append(first, n))
    runs = np.stack([array[first],
                     first - np.asarray(prog.piece_base)[array[first]],
                     row[first], bit[first], width[first], count], axis=1)
    runs = runs[np.lexsort((runs[:, 3], runs[:, 2]))]
    row_start = np.searchsorted(runs[:, 2], np.arange(prog.c_max + 1))
    table = PackRuns(runs=torch.from_numpy(runs.astype(np.int32)),
                     row_start=torch.from_numpy(row_start.astype(np.int32)),
                     c_max=prog.c_max, words32=prog.words32)
    prog.tables[key] = table
    return table


def device_pack_runs(prog: ExecProgram, device) -> PackRuns:
    """:func:`pack_run_table` on ``device``, built once per program and
    device."""
    device = torch.device(device)
    key = ("pack_runs", str(device))
    cached = prog.tables.get(key)
    if cached is None:
        cached = pack_run_table(prog).to(device)
        prog.tables[key] = cached
    return cached


def pack_runs(table: PackRuns, streams: list[torch.Tensor]
              ) -> torch.Tensor:
    """The pack kernel: ``streams[i]`` holds array ``i``'s pieces (uint8,
    int16, int32 or int64, read as 1-D; an index past its end reads 0),
    ``table`` says where each goes.  Returns the ``(c_max, words32)``
    int32-stored u32 bus rows, every word written once."""
    global launches
    devs = {s.device for s in streams} | {table.runs.device,
                                          table.row_start.device}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    dev = devs.pop()
    if any(s.dtype not in _KINDS for s in streams):
        raise ValueError(f"stream dtypes {[s.dtype for s in streams]}: the "
                         f"pack takes {sorted(map(str, _KINDS))}")
    if dev.type == "cpu":
        return pack_runs_plain(table.runs, streams, table.c_max,
                               table.words32)
    if dev.type != "cuda":
        raise ValueError(f"pack_runs runs on cpu or cuda, not {dev}")
    if len(streams) > MAX_ARRAYS:
        raise ValueError(f"{len(streams)} arrays: the pack kernel takes at "
                         f"most {MAX_ARRAYS}")
    out = torch.empty((table.c_max, table.words32), dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out
    flat = [s.reshape(-1) for s in streams]
    flat = [s if s.numel() < 2 or s.stride(0) == 1 else s.contiguous()
            for s in flat]
    n = len(flat)
    fn = build.function("layout_pack", "pack_runs_u32",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
    ptrs = (ctypes.c_ulonglong * n)(*(s.data_ptr() for s in flat))
    lens = (ctypes.c_longlong * n)(*(s.numel() for s in flat))
    kinds = (ctypes.c_int * n)(*(_KINDS[s.dtype] for s in flat))
    rc = fn(ptrs, lens, kinds, n, table.runs.data_ptr(),
            table.row_start.data_ptr(), out.data_ptr(), table.c_max,
            table.words32, build.stream_handle(dev))
    build.check_launch("pack_runs", rc)
    launches += 1
    return out


def pack_pieces(prog: ExecProgram, streams: list[torch.Tensor]
                ) -> torch.Tensor:
    """Pack per-array piece tensors with one kernel launch.

    ``streams[i]``: array ``i``'s pieces as integers holding their bits
    (uint8, int16, int32 or int64; int64 for pieces of 64 bits), at
    most ``prog.piece_depths[i]`` of them (the rest pack as 0), all on one
    device.  Each is read where it lies.  Returns the ``(c_max, m/8)``
    uint8 buffer on that device.
    """
    if len(streams) != len(prog.piece_depths):
        raise ValueError(f"{len(streams)} streams for "
                         f"{len(prog.piece_depths)} arrays")
    for i, s in enumerate(streams):
        if s.numel() > prog.piece_depths[i]:
            raise ValueError(f"array {i}: {s.numel()} pieces exceed its "
                             f"{prog.piece_depths[i]} slots")
    devs = {s.device for s in streams}
    if len(devs) != 1:
        raise ValueError(f"streams on different devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_pieces runs on cpu or cuda, not {dev}")
    words = pack_runs(device_pack_runs(prog, dev), streams)
    return words.view(torch.uint8).reshape(
        prog.c_max, prog.words32 * 4)[:, :prog.row_bytes]


def _check_stream(name: str, a, depth: int, ew: int) -> np.ndarray:
    arr = np.asarray(a).reshape(-1)
    if arr.dtype != np.uint64:
        arr = arr.astype(np.uint64)
    if arr.shape[0] != depth:
        raise ValueError(
            f"{name}: expected {depth} elements, got {arr.shape[0]}")
    if ew < 64 and (arr >> np.uint64(ew)).any():
        raise ValueError(f"{name}: codes overflow {ew} bits")
    return arr


def pack_layout_fused(layout: Layout, arrays: dict, *,
                      program: ExecProgram | None = None,
                      elem_widths: tuple[int, ...] | None = None,
                      device=None) -> np.ndarray:
    """Pack per-array piece streams (numpy) with one kernel launch.

    Returns the ``(c_max, m/8)`` uint8 buffer of
    :func:`~repro_torch.core.exec_plan.pack_compiled`, byte for byte.
    The kernel runs on ``device`` (``"cuda"`` unless given; ``"cpu"``
    runs its plain version).
    """
    prog = program if program is not None \
        else lower_exec(layout, elem_widths)
    device = resolve_device(device)
    streams = []
    for i, spec in enumerate(layout.problem.arrays):
        if spec.name not in arrays:
            raise KeyError(f"missing array {spec.name!r}")
        arr = _check_stream(spec.name, arrays[spec.name],
                            prog.piece_depths[i], prog.elem_widths[i])
        streams.append(torch.from_numpy(arr.view(np.int64)).to(device))
    return pack_pieces(prog, streams).cpu().numpy()
