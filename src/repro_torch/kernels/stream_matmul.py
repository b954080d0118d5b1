"""``stream_matmul``: ``x @ dequant(W)`` gathered straight out of an Iris stream.

Port of the TPU kernel ``src/repro/kernels/stream_matmul.py:stream_matmul``
as the hand-written CUDA kernel ``csrc/stream_matmul.cu`` (see its header
for what bounds it on an H100 and how its design answers that).

:func:`stream_matmul` is the wrapper: for CPU tensors it runs the plain
version :func:`stream_matmul_plain` (``kernels/ref.stream_matmul_ref``);
for CUDA tensors it launches the kernel on the current stream or raises.
It never falls back.  ``launches`` counts kernel launches, and
``weight_passes`` the gathers of a weight tile: a launch gathers and
dequantizes each weight once for every block of rows, its grid's z
extent.  :func:`stream_words` turns a packed ``(c_max, m/8)`` uint8
buffer into the flat word stream the kernel reads.

Bound on an H100 (3.35 TB/s HBM, 67 TFLOP/s f32): per decode step and
layer of smollm-135m the 7 calls read 16.5 MB, mostly the u32 offset
tables (4 B per weight), so with the tables coming from HBM the least
time is ~4.9 µs.  Every layer shares the tables and they fit the 50 MB
L2; with them resident ~1.9 MB remain, ~0.57 µs, which at the served
M <= 4 outweigh the 2·M·K·N f32 FLOPs (at M = 8 the FLOPs would bound
the 7 calls, at ~0.85 µs).  ``chip_smoke.py`` prints both bounds.

The kernel splits K into 8 ranges (the summation order of
``csrc/matmul_order.cuh``) and gives each (column tile, range, row
block) a block of its own: a row block is 8 rows at M <= 8 (decode) and
64 rows above, so that a 64-row step gathers each weight once;
:func:`matmul_launch` picks the column tile so that the grid covers the
card's SMs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import build
from .ref import stream_matmul_ref as stream_matmul_plain
from .ref import words_tensor

__all__ = ["launches", "matmul_launch", "stream_matmul",
           "stream_matmul_plain", "stream_words", "weight_passes"]

#: kernel launches made by :func:`stream_matmul` (reset by callers that
#: want to prove a run went through the kernel)
launches = 0
#: gathers of a weight tile by :func:`stream_matmul`: its grids' z
#: extents (the row blocks), summed over launches
weight_passes = 0

#: K ranges (blocks of one cluster) per column tile: MM_RANGES in
#: csrc/matmul_order.cuh
K_RANGES = 8
#: rows of a row tile (TILE_M in the .cu): a block of the decode kernel
#: covers one, at M <= 8
ROWS_PER_TILE = 8
#: output rows per block above M = 8 (MAX_TILES row tiles in the .cu);
#: the grid's z extent is at most 65535 blocks of rows
ROWS_PER_BLOCK = 64
MAX_M = ROWS_PER_BLOCK * 65535


def rows_per_block(m: int) -> int:
    """Output rows a block of the kernel covers at M = ``m``."""
    return ROWS_PER_TILE if m <= ROWS_PER_TILE else ROWS_PER_BLOCK


def matmul_launch(m: int, k: int, n: int, sms: int = build.H100_SMS
                  ) -> tuple[int, tuple[int, int, int]]:
    """Launch shape of the ``stream_matmul`` kernel for an (M, K) @ (K, N)
    product: ``(bn, grid)``.  ``bn`` is the output columns per block, the
    widest of 32, 16 and 8 whose grid ``(ceil(N / bn), 8, ceil(M /
    rows_per_block(M)))`` has at least ``sms`` blocks (8 when none has).
    Raises for an M the grid cannot hold."""
    if not 0 < m <= MAX_M or k < 1 or n < 1:
        raise ValueError(f"stream_matmul kernel takes 1 <= M <= {MAX_M}, "
                         f"K >= 1, N >= 1; got M={m} K={k} N={n}")
    m_blocks = -(-m // rows_per_block(m))
    for bn in (32, 16, 8):
        if -(-n // bn) * K_RANGES * m_blocks >= sms:
            break
    return bn, (-(-n // bn), K_RANGES, m_blocks)


#: the C launch function's argument types
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _check(x, words, w_tab, s_tab, bits, group_size):
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32]; got {bits}")
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got shape {tuple(x.shape)}")
    m, k = x.shape
    kt, n = w_tab.shape
    if kt != k:
        raise ValueError(f"w_tab K {kt} != activations K {k}")
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    if s_tab.shape != (k // group_size, n):
        raise ValueError(
            f"s_tab shape {tuple(s_tab.shape)} != {(k // group_size, n)}")
    if words.dtype != torch.int32 or w_tab.dtype != torch.int32 \
            or s_tab.dtype != torch.int32:
        raise ValueError("stream words and offset tables must be int32 "
                         "tensors holding uint32 bits")
    # get_device() (an int) is much cheaper than building torch.device
    # objects, and this runs 210 times per decode step
    if not (x.is_cuda == words.is_cuda == w_tab.is_cuda == s_tab.is_cuda
            and x.is_cpu == words.is_cpu == w_tab.is_cpu == s_tab.is_cpu
            and x.get_device() == words.get_device() == w_tab.get_device()
            == s_tab.get_device()):
        raise ValueError("operands on different devices: "
                         f"{[t.device for t in (x, words, w_tab, s_tab)]}")


def stream_matmul(x: torch.Tensor, words: torch.Tensor, w_tab: torch.Tensor,
                  s_tab: torch.Tensor, *, bits: int,
                  group_size: int) -> torch.Tensor:
    """``x @ dequant(stream)``: ``x`` (M, K) float, ``words`` the layer's
    flat int32-stored u32 stream, ``w_tab`` (K, N) and ``s_tab``
    (K / group_size, N) int32 global bit offsets.  Returns (M, N) f32."""
    global launches, weight_passes
    _check(x, words, w_tab, s_tab, bits, group_size)
    if not x.is_cuda:
        if x.is_cpu:
            return stream_matmul_plain(x, words, w_tab, s_tab, bits=bits,
                                       group_size=group_size)
        raise ValueError(f"stream_matmul runs on cpu or cuda, not {x.device}")
    m, k = x.shape
    n = w_tab.shape[1]
    xf = x if x.dtype == torch.float32 and x.is_contiguous() \
        else x.to(torch.float32).contiguous()
    words = words.contiguous()
    w_tab = w_tab.contiguous()
    s_tab = s_tab.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    bn, grid = matmul_launch(m, k, n, build.device_sms(x.device))
    fn = build.function("stream_matmul", "stream_matmul_f32", _ARGTYPES)
    rc = fn(xf.data_ptr(), words.data_ptr(), words.numel(),
            w_tab.data_ptr(), s_tab.data_ptr(), out.data_ptr(), m, k, n,
            bits, group_size, bn, build.stream_handle(x.device))
    build.check_launch("stream_matmul", rc)
    launches += 1
    weight_passes += grid[2]
    return out


def stream_words(program, buf_u8, device=None) -> torch.Tensor:
    """Packed ``(c_max, m/8)`` uint8 buffer -> the flat int32-stored u32
    word stream :func:`stream_matmul` reads (``program.buffer_words32``,
    each row padded to whole words).

    A numpy buffer is converted on the host once and sent to ``device``
    (``"cuda"`` unless given; ``RuntimeError`` without a card).  A uint8
    tensor is converted on its own device, or on ``device`` when given.
    """
    if isinstance(buf_u8, torch.Tensor):
        if tuple(buf_u8.shape) != (program.c_max, program.row_bytes) \
                or buf_u8.dtype != torch.uint8:
            raise ValueError(
                f"buffer {tuple(buf_u8.shape)} {buf_u8.dtype} != "
                f"({program.c_max}, {program.row_bytes}) uint8")
        if device is not None:
            buf_u8 = buf_u8.to(device)
        pad = program.words32 * 4 - program.row_bytes
        return F.pad(buf_u8, (0, pad)).contiguous().view(torch.int32) \
            .reshape(-1)
    words = program.buffer_words32(np.asarray(buf_u8, dtype=np.uint8))
    return words_tensor(words.reshape(-1), resolve_device(device))
