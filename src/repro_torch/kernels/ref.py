"""Plain PyTorch versions of the port's kernels, and the word type.

Own port of ``src/repro/kernels/ref.py:32-99``: the funnel-shift
:func:`extract`, :func:`stream_matmul_ref` (keeping the reference's
K-block accumulation order) and :func:`stream_kv_ref`.  They run on any
device; the kernel wrappers call them only for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

**Word type.**  PyTorch on the CPU has no shifts or comparisons for
``torch.uint32``, and ``int32 >>`` sign-extends.  So packed stream and
page words, and the uint32 bit-offset tables, are stored as
``torch.int32`` tensors holding the same bits (numpy ``.view(np.int32)``).
The plain versions widen them to int64 and mask with ``& 0xFFFFFFFF``;
the CUDA kernels reinterpret them as ``const uint32_t*``.  Bit-offset
tables must stay below 2^31 (one layer's int3 stream is ~12.4 Mbit):
:func:`table_tensor` checks this.
"""
from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF


def words_tensor(words_u32: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(words_u32, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def table_tensor(tab_u32: np.ndarray, device) -> torch.Tensor:
    """uint32 bit-offset table -> int32 tensor; raises if an offset does
    not fit int32 (the kernels index with signed 32-bit offsets)."""
    tab = np.asarray(tab_u32, dtype=np.uint32)
    if tab.size and int(tab.max()) >= (1 << 31):
        raise ValueError(
            f"bit offset {int(tab.max())} does not fit int32: the stream "
            "is too long for the port's int32 offset tables")
    return torch.from_numpy(np.ascontiguousarray(tab).view(np.int32)
                            .copy()).to(device)


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def bf16_bits_to_f32(pat: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns (int64 in [0, 2^16)) -> their f32 values."""
    return to_int32_bits(pat << 16).view(torch.float32)


def extract(words: torch.Tensor, tab: torch.Tensor, width: int
            ) -> torch.Tensor:
    """Funnel-shift ``width``-bit fields out of int32-stored u32 words.

    ``words``: ``(W,)`` or ``(B, W)`` (the gather runs per row); ``tab``:
    global bit offsets of any shape.  Returns int64 fields of shape
    ``tab.shape`` (or ``(B,) + tab.shape``).  The second word read is
    clamped to the last word; its bits land above ``width`` there.
    """
    flat = words.to(torch.int64) & U32
    t = tab.reshape(-1).to(torch.int64) & U32
    wi = t >> 5
    sh = t & 31
    last = flat.shape[-1] - 1
    lo = flat[..., wi] >> sh
    hi = flat[..., torch.clamp(wi + 1, max=last)] << ((32 - sh) & 63)
    v = torch.where(sh > 0, lo | hi, lo) & ((1 << width) - 1)
    return v.reshape(flat.shape[:-1] + tab.shape)


def stream_matmul_ref(x: torch.Tensor, words: torch.Tensor,
                      w_tab: torch.Tensor, s_tab: torch.Tensor, *,
                      bits: int, group_size: int,
                      block_k: int = 512) -> torch.Tensor:
    """Plain version of ``stream_matmul``: table decode, dequantize, then
    a dot accumulated over K blocks of ``block_k`` in order (the
    reference kernel's K-grid order)."""
    k, n = w_tab.shape
    codes = extract(words, w_tab, bits)
    scales = bf16_bits_to_f32(extract(words, s_tab, 16))
    wq = codes.to(torch.float32) - float(1 << (bits - 1))
    wf = (wq.reshape(k // group_size, group_size, n)
          * scales[:, None, :]).reshape(k, n)
    bk = min(block_k, k)
    bk = -(-bk // group_size) * group_size
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for kk in range(0, k, bk):
        acc = acc + xf[:, kk:kk + bk] @ wf[kk:kk + bk]
    return acc


def dequant_fields(codes: torch.Tensor, sc16: torch.Tensor, bits: int
                   ) -> torch.Tensor:
    """``(codes - 2^(bits-1)) * bf16(scale)`` with one scale per vector
    (the last dimension of ``codes``)."""
    bias = float(1 << (bits - 1))
    return (codes.to(torch.float32) - bias) * bf16_bits_to_f32(sc16)[..., None]


def stream_kv_ref(words: torch.Tensor, tabs: dict, *, bits: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequantized f32 K and V from packed KV page words.

    ``words``: one slot's ``(W,)`` words or ``(B, W)`` rows; ``tabs``: the
    full-sequence tables (``k``/``v``: ``(smax, Hkv, hd)``, scales
    ``(smax, Hkv)``) as int32 tensors.  Returns ``(..., smax, Hkv, hd)``.
    """
    def one(code_tab, scale_tab):
        return dequant_fields(extract(words, code_tab, bits),
                              extract(words, scale_tab, 16), bits)

    return (one(tabs["k"], tabs["k_scales"]),
            one(tabs["v"], tabs["v_scales"]))
