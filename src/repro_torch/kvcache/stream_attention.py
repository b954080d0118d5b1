"""``stream_attention``: decode attention straight from packed KV pages.

Port of the TPU kernel
``src/repro/kvcache/kernels/stream_attention.py:stream_attention`` as the
hand-written CUDA kernel ``csrc/stream_attention.cu`` (see its header for
what bounds it on an H100 and how its design answers that).

:func:`stream_attention` is the wrapper: for CPU tensors it runs the
plain version :func:`stream_attention_plain` (extraction through
``kernels/ref.stream_kv_ref``, then
:func:`repro_torch.models.attention.decode_attention`); for CUDA tensors
it launches the kernel on the current stream or raises.  The kernel reads
each slot's page words directly from the rows of ``words`` picked by
``slot_ids``; :func:`stream_attention_cache` passes the cache's
``(n_slots, W)`` page view of one layer, so no gathered copy is made.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build
from ..kernels.ref import stream_kv_ref
from ..models.attention import decode_attention

__all__ = ["launches", "stream_attention", "stream_attention_cache",
           "stream_attention_plain"]

#: kernel launches made by :func:`stream_attention`
launches = 0

#: query heads per KV head one kernel block serves (MAX_REP in the .cu)
MAX_REP = 8
#: dynamic shared memory one block may use on an H100
MAX_SMEM = 227 * 1024


def stream_attention_plain(words, slot_ids, q, pos, k_tab, ks_tab, v_tab,
                           vs_tab, *, bits: int) -> torch.Tensor:
    """Plain version: dequantize K/V of the selected rows, then the dense
    decode attention (``decode_attention``) over them."""
    tabs = {"k": k_tab, "k_scales": ks_tab, "v": v_tab, "v_scales": vs_tab}
    kf, vf = stream_kv_ref(words[slot_ids.to(torch.int64)], tabs, bits=bits)
    return decode_attention(q, kf, vf, pos)


def stream_attention(words: torch.Tensor, slot_ids: torch.Tensor,
                     q: torch.Tensor, pos: torch.Tensor,
                     k_tab: torch.Tensor, ks_tab: torch.Tensor,
                     v_tab: torch.Tensor, vs_tab: torch.Tensor, *,
                     bits: int) -> torch.Tensor:
    """Decode attention over packed KV pages.

    ``words``: ``(R, W)`` int32 page words, one row per cache slot;
    ``slot_ids``: ``(B,)`` rows to attend with; ``q``: ``(B, 1, H, hd)``
    bf16; ``pos``: ``(B,)`` per-slot positions; tables: full-sequence
    int32 bit offsets (``k``/``v`` ``(smax, Hkv, hd)``, scales
    ``(smax, Hkv)``).  Returns ``(B, 1, H, hd)`` bf16.
    """
    global launches
    b, one, h, hd = q.shape
    smax, hkv, hd_t = k_tab.shape
    if one != 1 or hd_t != hd:
        raise ValueError(f"q shape {tuple(q.shape)} does not match the "
                         f"tables' head_dim {hd_t}")
    if h % hkv:
        raise ValueError(f"{h} query heads not a multiple of {hkv} KV heads")
    if tuple(ks_tab.shape) != (smax, hkv) or tuple(vs_tab.shape) != (smax, hkv) \
            or tuple(v_tab.shape) != (smax, hkv, hd):
        raise ValueError("KV tables disagree in shape")
    if slot_ids.shape != (b,) or pos.shape != (b,):
        raise ValueError("slot_ids and pos must be (B,)")
    if words.dtype != torch.int32 or any(
            t.dtype != torch.int32 for t in (k_tab, ks_tab, v_tab, vs_tab)):
        raise ValueError("page words and tables must be int32 tensors "
                         "holding uint32 bits")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bfloat16, got {q.dtype}")
    if q.device.type == "cpu":
        return stream_attention_plain(words, slot_ids, q, pos, k_tab, ks_tab,
                                      v_tab, vs_tab, bits=bits)
    if q.device.type != "cuda":
        raise ValueError(f"stream_attention runs on cpu or cuda, not {q.device}")
    rep = h // hkv
    if rep > MAX_REP:
        raise ValueError(f"{rep} query heads per KV head > {MAX_REP}")
    smem = 4 * (rep * hd + rep * smax + 32)
    if smem > MAX_SMEM:
        raise ValueError(f"smax={smax} needs {smem} B of shared memory")
    if not 1 <= bits <= 31:
        raise ValueError(f"bits must be in [1, 31]; got {bits}")
    if words.ndim != 2 or not words.is_contiguous():
        raise ValueError("words must be a contiguous (R, W) tensor")
    q = q.contiguous()
    slot_ids = slot_ids.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    tabs = [t.contiguous() for t in (k_tab, ks_tab, v_tab, vs_tab)]
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = build.load("stream_attention")
    fn = lib.stream_attention_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] \
        + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(words.data_ptr(), words.shape[1], slot_ids.data_ptr(),
            q.data_ptr(), pos.data_ptr(), *[t.data_ptr() for t in tabs],
            out.data_ptr(), b, h, hkv, hd, smax, bits,
            float(np.float32(hd ** -0.5)),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("stream_attention", rc)
    launches += 1
    return out


def stream_attention_cache(kvc, q: torch.Tensor, pos: torch.Tensor,
                           slot_ids: torch.Tensor, *,
                           layer: int) -> torch.Tensor:
    """Front door over a :class:`~repro_torch.kvcache.PackedKVCache`: the
    kernel reads the layer's ``(n_slots, W)`` page view through
    ``slot_ids`` directly (no gathered copy of the active slots)."""
    tabs = kvc.device_stream_tables()
    return stream_attention(kvc.layer_words(layer), slot_ids, q, pos,
                            tabs["k"], tabs["k_scales"], tabs["v"],
                            tabs["v_scales"], bits=kvc.bits)
