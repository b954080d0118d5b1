"""GQA attention: blockwise flash for prefill, direct for decode.

Port of ``src/repro/models/attention.py``: :data:`NEG_INF`,
:func:`init_attention`, :func:`_project`, :func:`flash_attention`
(``:64-130``), :func:`decode_attention`, :func:`stream_decode_attention`
over a packed KV cache, :func:`attention_block` (``:182-200``),
:func:`attention_decode_block` (``:202-222``), and whisper's
cross-attention: :func:`cross_kv` and :func:`cross_attention_block`
(``:224-243``).

:func:`flash_attention` is the reference's online softmax over query and
key/value blocks, in plain PyTorch (it is no Pallas kernel): f32 scores
of the model-dtype inputs, masked to ``NEG_INF``, the V contraction in
f32, the output in the query dtype.  It does not call
``scaled_dot_product_attention``.
"""
from __future__ import annotations

import torch

from .layers import apply_rope, dense_init
from .shard_utils import gather_grad, is_dtensor, split_heads, unshard

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, *, lead: tuple = (),
                   device=None) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = getattr(torch, cfg.dtype)

    def dense(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, dtype, lead=lead, scale=scale,
                          device=device)

    p = {"wq": dense(d, h * hd), "wk": dense(d, hkv * hd),
         "wv": dense(d, hkv * hd),
         "wo": dense(h * hd, d, scale=(h * hd) ** -0.5)}
    if cfg.use_bias:
        for name, n in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd),
                        ("bo", d)):
            p[name] = torch.zeros(lead + (n,), dtype=dtype, device=device)
    return p


def _project(cfg, p: dict, x: torch.Tensor, name: str) -> torch.Tensor:
    y = x @ p[f"w{name}"]
    if cfg.use_bias:
        y = y + p[f"b{name}"]
    return y


def _gather_gqa_heads(q, k, v):
    """Explicit gather: DTensor cannot regroup a sharded head dim into
    (Hkv, rep) unless Hkv divides over its ranks, which GQA's few KV
    heads often do not; placed GQA attention gathers the head dim of q,
    k and v first (identity on plain tensors and without GQA)."""
    if is_dtensor(q) and k.shape[2] != q.shape[2]:
        return unshard(q, 2), unshard(k, 2), unshard(v, 2)
    return q, k, v


def repeat_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by GQA group replication."""
    hkv = kv.shape[2]
    if hkv == n_heads:
        return kv
    # placed: the backward of the repeat regroups the gradient's heads,
    # which DTensor refuses on a sharded head dim (see _gather_gqa_heads)
    return gather_grad(torch.repeat_interleave(kv, n_heads // hkv, dim=2),
                       2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd).  Returns (B, Sq, H, hd)."""
    q, k, v = _gather_gqa_heads(q, k, v)
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    scale = hd ** -0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq, nkv = -(-sq // q_chunk), -(-skv // kv_chunk)
    dev = q.device
    outs = []
    for qi in range(nq):
        q_base = qi * q_chunk
        qb = q[:, q_base:q_base + q_chunk].to(torch.float32)
        cq = qb.shape[1]
        q_pos = torch.arange(q_base, q_base + cq, device=dev)
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        lsum = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=dev)
        for kj in range(nkv):
            kv_base = kj * kv_chunk
            kb = k[:, kv_base:kv_base + kv_chunk].to(torch.float32)
            vb = v[:, kv_base:kv_base + kv_chunk].to(torch.float32)
            kv_pos = torch.arange(kv_base, kv_base + kb.shape[1], device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            if causal:
                mask = kv_pos[None, :] <= q_pos[:, None]
                s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                       vb)
            m = m_new
        out = acc / torch.clamp(lsum, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))                 # (B, cq, H, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, Smax, Hkv, hd); pos: (B,) per-row
    positions.  K/V are cast to the query dtype, scores and softmax are
    f32, the V contraction is f32, the output is in the query dtype."""
    q, k_cache, v_cache = _gather_gqa_heads(q, k_cache, v_cache)
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


def attention_block(cfg, p: dict, x: torch.Tensor, positions, inv_freq,
                    causal: bool = True,
                    kv_override: tuple[torch.Tensor, torch.Tensor] | None
                    = None) -> torch.Tensor:
    """Full-sequence attention (prefill, encoder, or cross-attention over
    ``kv_override``, the encoder memory's K/V).  x: (B, S, d)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(_project(cfg, p, x, "q"), b, s, h, hd)
    if kv_override is None:
        k = split_heads(_project(cfg, p, x, "k"), b, s, hkv, hd)
        v = split_heads(_project(cfg, p, x, "v"), b, s, hkv, hd)
        q = apply_rope(q, positions, inv_freq, cfg.mrope_sections)
        k = apply_rope(k, positions, inv_freq, cfg.mrope_sections)
    else:
        k, v = kv_override
    out = flash_attention(q, k, v, causal=causal)
    return _project(cfg, p, out.reshape(b, s, h * hd), "o")


def attention_decode_block(cfg, p: dict, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: torch.Tensor, inv_freq) -> torch.Tensor:
    """One-token step; x: (B, 1, d); pos: (B,) per-row write positions.

    Writes this token's K/V into the caches **in place** (the reference
    returns new caches).  A row whose position is past the cache keeps its
    cache unchanged, as the reference's out-of-range ``.at[].set`` drops
    the write (an idle engine slot steps on and is reset on admission).
    Returns the block's output (B, 1, d)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(_project(cfg, p, x, "q"), b, 1, h, hd)
    k = split_heads(_project(cfg, p, x, "k"), b, 1, hkv, hd)
    v = split_heads(_project(cfg, p, x, "v"), b, 1, hkv, hd)
    pos_b = pos[:, None]
    q = apply_rope(q, pos_b, inv_freq, cfg.mrope_sections)
    k = apply_rope(k, pos_b, inv_freq, cfg.mrope_sections)
    rows = torch.arange(b, device=x.device)
    smax = k_cache.shape[1]
    idx = pos.to(torch.int64).clamp(max=smax - 1)
    keep = (pos < smax)[:, None, None]
    if is_dtensor(k_cache):
        # explicit: DTensor has no rule for an in-place index_put_ on a
        # sharded cache, so a placed cache takes the write as a masked
        # select over the whole cache, copied back into its shards
        hit = (torch.arange(smax, device=pos.device)[None] == idx[:, None])
        hit = (hit & keep[:, :, 0])[:, :, None, None]          # (B, S, 1, 1)
        k_cache.copy_(torch.where(hit, k.to(k_cache.dtype), k_cache))
        v_cache.copy_(torch.where(hit, v.to(v_cache.dtype), v_cache))
    else:
        k_cache[rows, idx] = torch.where(keep, k[:, 0].to(k_cache.dtype),
                                         k_cache[rows, idx])
        v_cache[rows, idx] = torch.where(keep, v[:, 0].to(v_cache.dtype),
                                         v_cache[rows, idx])
    out = decode_attention(q, k_cache, v_cache, pos)
    return _project(cfg, p, out.reshape(b, 1, h * hd), "o")


def cross_kv(cfg, p: dict, memory: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder memory (B, ctx, d) to cross K/V, each (B, ctx, Hkv, hd)."""
    b, s, _ = memory.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    k = split_heads(_project(cfg, p, memory, "k"), b, s, hkv, hd)
    v = split_heads(_project(cfg, p, memory, "v"), b, s, hkv, hd)
    return k, v


def cross_attention_block(cfg, p: dict, x: torch.Tensor,
                          memory: torch.Tensor | None = None,
                          kv: tuple[torch.Tensor, torch.Tensor] | None = None
                          ) -> torch.Tensor:
    """Decoder cross-attention over the encoder ``memory`` (prefill) or
    its precomputed ``kv`` (decode)."""
    if kv is None:
        kv = cross_kv(cfg, p, memory)
    return attention_block(cfg, p, x, None, None, causal=False,
                           kv_override=kv)
