"""``packed_matmul``: ``x @ dequant(W)`` over lane-packed int-N weight codes.

Port of the TPU kernel ``src/repro/kernels/packed_matmul.py:packed_matmul``
as the hand-written CUDA kernel ``csrc/packed_matmul.cu`` (see its header
for what bounds it on an H100 and how its design answers that).  It reads
a tree's lane-packed kernel views (:func:`repro_torch.quant.pack_codes_u32`):
``32 / bits`` consecutive K codes of one column per u32 word.

:func:`packed_matmul` is the wrapper: for CPU tensors it runs the plain
version :func:`packed_matmul_plain` (``kernels/ref.packed_matmul_ref``);
for CUDA tensors it launches the kernel on the current stream or raises.
It never falls back.  ``launches`` counts kernel launches.

The Pallas kernel needs K and N to tile by its blocks (at smollm-135m's
full width it refuses all four matrix shapes); the function is defined
for any K divisible by the group size and by ``32 / bits``, and so is
this kernel.  It sums in ``stream_matmul.cu``'s f32 order, so on one
tree the lane-packed and the stream-direct paths give the same bits.
Like ``stream_matmul`` it splits K into 8 ranges, one block each, and
takes its column tile from :func:`~repro_torch.kernels.stream_matmul.
matmul_launch`, so that the grid covers the card's SMs.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import packed_matmul_ref as packed_matmul_plain
from .stream_matmul import matmul_launch

__all__ = ["SUPPORTED_BITS", "launches", "packed_matmul",
           "packed_matmul_plain"]

#: element widths the lane-packed path supports: a whole number of codes
#: per u32 word (32 % bits == 0)
SUPPORTED_BITS = (2, 4, 8)

#: kernel launches made by :func:`packed_matmul`
launches = 0

#: the C launch function's argument types
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def packed_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                  scales: torch.Tensor, *, bits: int,
                  group_size: int) -> torch.Tensor:
    """``x @ dequant(w_packed, scales)``: ``x`` (M, K) float, ``w_packed``
    (K * bits / 32, N) int32-stored u32 words, ``scales`` (K / group_size,
    N) bfloat16.  Returns (M, N) f32."""
    global launches
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"packed_matmul supports bits in "
                         f"{sorted(SUPPORTED_BITS)}; got {bits}")
    if x.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} and w_packed "
                         f"{tuple(w_packed.shape)} must be 2-D")
    m, k = x.shape
    lanes = 32 // bits
    kw, n = w_packed.shape
    if kw * lanes != k:
        raise ValueError(f"packed K mismatch: {kw}*{lanes} != {k}")
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    if tuple(scales.shape) != (k // group_size, n):
        raise ValueError(f"scales shape {tuple(scales.shape)} != "
                         f"{(k // group_size, n)}")
    if w_packed.dtype != torch.int32 or scales.dtype != torch.bfloat16:
        raise ValueError("w_packed must be int32 (u32 bits) and scales "
                         "bfloat16")
    # get_device() (an int) is much cheaper than building torch.device
    # objects, and this runs 210 times per decode step
    if not (x.is_cuda == w_packed.is_cuda == scales.is_cuda
            and x.is_cpu == w_packed.is_cpu == scales.is_cpu
            and x.get_device() == w_packed.get_device()
            == scales.get_device()):
        raise ValueError("operands on different devices: "
                         f"{[t.device for t in (x, w_packed, scales)]}")
    if not x.is_cuda:
        if x.is_cpu:
            return packed_matmul_plain(x, w_packed, scales, bits=bits,
                                       group_size=group_size)
        raise ValueError(f"packed_matmul runs on cpu or cuda, not {x.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    xf = x if x.dtype == torch.float32 and x.is_contiguous() \
        else x.to(torch.float32).contiguous()
    if not w_packed.is_contiguous():
        w_packed = w_packed.contiguous()
    if not scales.is_contiguous():
        scales = scales.contiguous()
    bn, _ = matmul_launch(m, k, n, build.device_sms(x.device))
    fn = build.function("packed_matmul", "packed_matmul_f32", _ARGTYPES)
    rc = fn(xf.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, k, n, bits, group_size, bn,
            build.stream_handle(x.device))
    build.check_launch("packed_matmul", rc)
    launches += 1
    return out
