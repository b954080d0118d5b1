"""Decode attention (single query position over a KV cache).

Port of ``src/repro/models/attention.py:24, 52-62, 133-176``:
:data:`NEG_INF`, :func:`decode_attention` (plain PyTorch) and
:func:`stream_decode_attention` over a packed KV cache.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by GQA group replication."""
    hkv = kv.shape[2]
    if hkv == n_heads:
        return kv
    return torch.repeat_interleave(kv, n_heads // hkv, dim=2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, Smax, Hkv, hd); pos: (B,) per-row
    positions.  K/V are cast to the query dtype, scores and softmax are
    f32, the V contraction is f32, the output is in the query dtype."""
    b, _, h, hd = q.shape
    smax = k_cache.shape[1]
    kc = repeat_kv(k_cache, h).to(q.dtype)
    vc = repeat_kv(v_cache, h).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     kc.to(torch.float32)) * hd ** -0.5
    valid = torch.arange(smax, device=q.device)[None, None, None, :] \
        <= pos.to(q.device)[:, None, None, None]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vc.to(torch.float32))
    return out.to(q.dtype)


def stream_decode_attention(kvc, q: torch.Tensor, pos: torch.Tensor,
                            slot_ids: torch.Tensor, *, layer: int,
                            oracle: bool = False,
                            plain: bool = False) -> torch.Tensor:
    """Decode attention straight off a packed KV cache.

    The default runs ``stream_attention`` (the CUDA kernel on a CUDA
    cache, its plain version on a CPU one).  ``oracle=True`` materializes
    the dequantized K/V (``kvc.dense_kv``) and runs
    :func:`decode_attention` over them; ``plain=True`` runs the kernel's
    plain version on whatever device the cache is on.
    """
    if oracle:
        kf, vf = kvc.dense_kv(layer, slot_ids)
        return decode_attention(q, kf, vf, pos)
    from ..kvcache.stream_attention import (
        stream_attention_cache,
        stream_attention_plain,
    )

    if plain:
        tabs = kvc.device_stream_tables()
        return stream_attention_plain(
            kvc.layer_words(layer), slot_ids, q, pos, tabs["k"],
            tabs["k_scales"], tabs["v"], tabs["v_scales"], bits=kvc.bits)
    return stream_attention_cache(kvc, q, pos, slot_ids, layer=layer)
