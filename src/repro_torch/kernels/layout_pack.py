"""``pack_layout_fused``: pack per-array piece streams into an Iris bus buffer.

Port of the TPU kernel ``src/repro/kernels/layout_pack.py:pack_layout_fused``
as the hand-written CUDA kernel ``csrc/layout_pack.cu`` (see its header for
what bounds it on an H100 and how its design answers that).  The inverse
of :mod:`repro_torch.kernels.layout_decode`: every destination u32 word is
the OR of at most K gathered, shifted fields, through gather-only
contribution tables (:func:`~repro_torch.core.exec_plan.split_pack_tables`).

:func:`pack_words` is the kernel's wrapper: for CPU tensors it runs the
plain version :func:`pack_words_plain` (``kernels/ref.pack_fused_ref``);
for CUDA tensors it launches the kernel on the current stream or raises.
It never falls back.  ``launches`` counts kernel launches.

:func:`pack_pieces` packs per-array tensors on their device and returns
the buffer there (``tree.pack_tree`` packs every layer with it);
:func:`pack_layout_fused` is the layout-level entry point over numpy
streams, byte-equal to :func:`~repro_torch.core.exec_plan.pack_compiled`.
Pieces wider than 32 bits (up to 64) enter the kernel as two u32 fields
(:func:`~repro_torch.core.exec_plan.split_pieces`); the reference packs
those arrays on the host instead.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.exec_plan import ExecProgram, lower_exec, split_pack_tables
from ..core.layout import Layout
from ..device import resolve_device
from . import build
from .ref import U32, to_int32_bits
from .ref import pack_fused_ref as pack_words_plain

__all__ = ["launches", "pack_layout_fused", "pack_pieces", "pack_words",
           "pack_words_plain"]

#: kernel launches made by :func:`pack_words`
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


def pack_pieces(prog: ExecProgram, streams: list[torch.Tensor]
                ) -> torch.Tensor:
    """Pack per-array piece tensors with one kernel launch.

    ``streams[i]``: array ``i``'s pieces as integers holding their bits
    (int64 for pieces of 64 bits), at most ``prog.piece_depths[i]`` of
    them (the rest pack as 0), all on one device.  Returns the ``(c_max,
    m/8)`` uint8 buffer on that device.
    """
    if len(streams) != len(prog.piece_depths):
        raise ValueError(f"{len(streams)} streams for "
                         f"{len(prog.piece_depths)} arrays")
    devs = {s.device for s in streams}
    if len(devs) != 1:
        raise ValueError(f"streams on different devices: {devs}")
    dev = devs.pop()
    wide = sum(prog.piece_depths[i] for i in prog.host_arrays)
    flat = torch.zeros(1 + prog.n_pieces + wide, dtype=torch.int64,
                       device=dev)
    hi = 1 + prog.n_pieces
    for i, s in enumerate(streams):
        s = s.reshape(-1).to(torch.int64)
        if s.shape[0] > prog.piece_depths[i]:
            raise ValueError(f"array {i}: {s.shape[0]} pieces exceed its "
                             f"{prog.piece_depths[i]} slots")
        base = 1 + prog.piece_base[i]
        flat[base:base + s.shape[0]] = s & U32
        if i in prog.host_arrays:
            flat[hi:hi + s.shape[0]] = (s >> 32) & U32
            hi += prog.piece_depths[i]
    src, scode = device_pack_tables(prog, dev)
    words = pack_words(to_int32_bits(flat), src, scode)
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
