"""``stream_matmul``: ``x @ dequant(W)`` gathered straight out of an Iris stream.

Port of the TPU kernel ``src/repro/kernels/stream_matmul.py:stream_matmul``
as the hand-written CUDA kernel ``csrc/stream_matmul.cu`` (see its header
for what bounds it on an H100 and how its design answers that).

:func:`stream_matmul` is the wrapper: for CPU tensors it runs the plain
version :func:`stream_matmul_plain` (``kernels/ref.stream_matmul_ref``);
for CUDA tensors it launches the kernel on the current stream or raises.
It never falls back.  ``launches`` counts kernel launches.

Bound on an H100 (3.35 TB/s HBM, 67 TFLOP/s f32): per decode step and
layer of smollm-135m the 7 calls read 16.5 MB, mostly the u32 offset
tables (4 B per weight), so with the tables coming from HBM the least
time is ~4.9 µs.  Every layer shares the tables and they fit the 50 MB
L2; with them resident ~1.9 MB remain, and the 2·M·K·N f32 FLOPs (M = 8)
bound the 7 calls at ~0.85 µs.  ``chip_smoke.py`` prints both bounds.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import stream_matmul_ref as stream_matmul_plain

__all__ = ["launches", "stream_matmul", "stream_matmul_plain"]

#: kernel launches made by :func:`stream_matmul` (reset by callers that
#: want to prove a run went through the kernel)
launches = 0


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
    if tuple(s_tab.shape) != (k // group_size, n):
        raise ValueError(
            f"s_tab shape {tuple(s_tab.shape)} != {(k // group_size, n)}")
    if words.dtype != torch.int32 or w_tab.dtype != torch.int32 \
            or s_tab.dtype != torch.int32:
        raise ValueError("stream words and offset tables must be int32 "
                         "tensors holding uint32 bits")
    devs = {t.device for t in (x, words, w_tab, s_tab)}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")


def stream_matmul(x: torch.Tensor, words: torch.Tensor, w_tab: torch.Tensor,
                  s_tab: torch.Tensor, *, bits: int,
                  group_size: int) -> torch.Tensor:
    """``x @ dequant(stream)``: ``x`` (M, K) float, ``words`` the layer's
    flat int32-stored u32 stream, ``w_tab`` (K, N) and ``s_tab``
    (K / group_size, N) int32 global bit offsets.  Returns (M, N) f32."""
    global launches
    _check(x, words, w_tab, s_tab, bits, group_size)
    if x.device.type == "cpu":
        return stream_matmul_plain(x, words, w_tab, s_tab, bits=bits,
                                   group_size=group_size)
    if x.device.type != "cuda":
        raise ValueError(f"stream_matmul runs on cpu or cuda, not {x.device}")
    m, k = x.shape
    n = w_tab.shape[1]
    xf = x.to(torch.float32).contiguous()
    words = words.contiguous()
    w_tab = w_tab.contiguous()
    s_tab = s_tab.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = build.load("stream_matmul")
    fn = lib.stream_matmul_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(xf.data_ptr(), words.data_ptr(), words.numel(),
            w_tab.data_ptr(), s_tab.data_ptr(), out.data_ptr(), m, k, n,
            bits, group_size, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("stream_matmul", rc)
    launches += 1
    return out
