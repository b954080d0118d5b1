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

The kernel splits each slot's sequence across a cluster of up to 8
blocks per (slot, KV head) and merges their partial softmax results;
:func:`attention_launch` picks the split and the shared memory, which
does not grow with ``smax``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build
from ..kernels.ref import stream_kv_ref
from ..models.attention import decode_attention

__all__ = ["attention_launch", "launches", "stream_attention",
           "stream_attention_cache", "stream_attention_plain"]

#: kernel launches made by :func:`stream_attention`
launches = 0

#: the widest head the kernel takes
MAX_HD = 256
#: tokens per tile of a block (TT in the .cu: one per lane)
TILE_TOKENS = 32
#: blocks of one cluster, at most (the portable cluster size)
MAX_SPLITS = 8
#: dynamic shared memory one block may use on an H100
MAX_SMEM = 227 * 1024
#: the C launch function's argument types
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def attention_launch(b: int, hkv: int, rep: int, hd: int, smax: int,
                     sms: int = build.H100_SMS) -> tuple[int, int, int]:
    """Launch shape of the ``stream_attention`` kernel: ``(splits,
    tokens_per_block, smem_bytes)``.

    The grid is ``(b, hkv, splits)``, one cluster of ``splits`` blocks
    per (slot, KV head); block ``s`` owns tokens ``[s * tokens_per_block,
    (s + 1) * tokens_per_block)``.  ``splits`` is the fewest that bring
    the grid to ``sms`` blocks, capped at 8 and at the number of 32-token
    tiles in ``smax``.  Shared memory (the carve-up in the .cu, in f32
    words): q and the partial output, ``rep * hd`` each; one tile of K
    (rows padded to ``hd + 1``) and of V; per query head the tile's
    probabilities, its rescale, m and l.  Any ``rep`` whose block fits
    ``MAX_SMEM`` is taken (up to 171 at hd 128, 76 at hd 256).  Raises
    for what the kernel refuses."""
    if rep < 1:
        raise ValueError(f"{rep} query heads per KV head: the kernel takes "
                         f"at least 1")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"head_dim {hd}: the kernel takes 1..{MAX_HD}")
    if b < 1 or hkv < 1 or smax < 1:
        raise ValueError(f"empty launch: B={b} Hkv={hkv} smax={smax}")
    tiles = -(-smax // TILE_TOKENS)
    splits = max(1, min(MAX_SPLITS, tiles, -(-sms // (b * hkv))))
    words = (2 * rep * hd + TILE_TOKENS * (2 * hd + 1)
             + rep * (TILE_TOKENS + 3))
    if 4 * words > MAX_SMEM:
        raise ValueError(f"{rep} query heads per KV head at head_dim {hd} "
                         f"need {4 * words} B of shared memory a block; an "
                         f"H100 block has {MAX_SMEM}")
    return splits, -(-smax // splits), 4 * words


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
    if ks_tab.shape != (smax, hkv) or vs_tab.shape != (smax, hkv) \
            or v_tab.shape != (smax, hkv, hd):
        raise ValueError("KV tables disagree in shape")
    if slot_ids.shape != (b,) or pos.shape != (b,):
        raise ValueError("slot_ids and pos must be (B,)")
    if not (words.dtype == k_tab.dtype == ks_tab.dtype == v_tab.dtype
            == vs_tab.dtype == torch.int32):
        raise ValueError("page words and tables must be int32 tensors "
                         "holding uint32 bits")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bfloat16, got {q.dtype}")
    if not q.is_cuda:
        if q.is_cpu:
            return stream_attention_plain(words, slot_ids, q, pos, k_tab,
                                          ks_tab, v_tab, vs_tab, bits=bits)
        raise ValueError(f"stream_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if not 1 <= bits <= 31:
        raise ValueError(f"bits must be in [1, 31]; got {bits}")
    if words.ndim != 2 or not words.is_contiguous():
        raise ValueError("words must be a contiguous (R, W) tensor")
    q = q.contiguous()
    # the kernel reads int32 or int64 ids and positions as they come
    idx = [t.contiguous() if t.dtype in (torch.int32, torch.int64)
           else t.to(torch.int64).contiguous() for t in (slot_ids, pos)]
    tabs = [t.contiguous() for t in (k_tab, ks_tab, v_tab, vs_tab)]
    out = torch.empty_like(q)
    if b == 0:
        return out
    splits, tpb, smem = attention_launch(b, hkv, h // hkv, hd, smax,
                                         build.device_sms(q.device))
    fn = build.function("stream_attention", "stream_attention_bf16",
                        _ARGTYPES)
    rc = fn(words.data_ptr(), words.shape[1], idx[0].data_ptr(),
            idx[0].dtype == torch.int64, q.data_ptr(), idx[1].data_ptr(),
            idx[1].dtype == torch.int64, *[t.data_ptr() for t in tabs],
            out.data_ptr(), b, h, hkv, hd, smax, splits, tpb, smem, bits,
            float(np.float32(hd ** -0.5)), build.stream_handle(q.device))
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
