"""Quantized decode path: serve from Iris-packed weight streams.

Port of ``src/repro/models/quantized.py:39-44, 88-103, 106-293``:
:func:`quantizable`, :func:`_pmm_direct`, :func:`packed_decode_step`
(``weights``, ``slot_ids``, ``kv``, ``kv_attention``) and
:func:`bytes_per_token_report`.  Every weight matmul gathers codes and
scales straight out of the layer's packed stream (``stream_matmul``); with
``kv="packed"`` the KV cache is an Iris-planned packed stream too, read
by ``stream_attention``.  The final ``logits = x @ embed.T`` is a plain
product outside any kernel and stays ``torch.matmul``.

State is a dict of tensors: ``pos`` (B,) int32, plus ``k_cache`` /
``v_cache`` (dense KV) or ``packed_kv`` (a
:class:`~repro_torch.kvcache.PackedKVCache`).  Unlike the reference the
caches are updated **in place**; the returned state holds the same cache
objects and a new ``pos``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import decode_attention, stream_decode_attention
from .layers import activation, apply_norm, apply_rope, rope_freqs


def quantizable(cfg) -> bool:
    """The packed decode path covers the dense sublayer template."""
    return cfg.family == "dense"


def init_decode_state(cfg, batch_size: int, max_seq: int, *,
                      kv: str = "dense", device) -> dict:
    """Per-slot clocks, plus dense bf16 K/V caches when ``kv="dense"``
    (a packed cache is created by the caller into ``packed_kv``)."""
    state = {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                                device=device)}
    if kv == "dense":
        shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        dtype = getattr(torch, cfg.dtype)
        state["k_cache"] = torch.zeros(shape, dtype=dtype, device=device)
        state["v_cache"] = torch.zeros(shape, dtype=dtype, device=device)
    return state


def _pmm_direct(x2d: torch.Tensor, pp, name: str, layer: int, *,
                plain: bool = False) -> torch.Tensor:
    """Stream-direct ``x2d @ dequant(name)`` for layer ``layer``; pads M
    to a power of two >= 8 as the reference does."""
    b = x2d.shape[0]
    bm = max(8, 1 << (b - 1).bit_length())
    if bm != b:
        x2d = F.pad(x2d, (0, 0, 0, bm - b))
    return pp.matmul_direct(x2d, name, layer, plain=plain)[:b]


def packed_decode_step(cfg, pp, state: dict, tokens: torch.Tensor, *,
                       weights: str = "auto", slot_ids=None,
                       kv: str = "dense", kv_attention: str = "stream",
                       plain: bool = False
                       ) -> tuple[torch.Tensor, dict]:
    """One decode token with stream-direct weights (dense archs).

    ``weights``: ``"auto"`` and ``"stream"`` gather straight from the
    per-layer streams; ``"packed"`` (lane-packed views) is ROADMAP B2.
    ``slot_ids``: the active cache rows aligned with ``tokens`` (ragged
    M); ``None`` steps every row.  ``kv``: ``"dense"`` bf16 caches or
    ``"packed"`` (``state["packed_kv"]``), read by the stream attention
    kernel (``kv_attention="stream"``) or a materialized dequant oracle
    (``"dense"``).  ``plain=True`` runs the kernels' plain versions on the
    tree's device — the reference run the on-card check compares with.
    Returns ``(logits (B, V) in the model dtype, new state)``.
    """
    if weights not in ("auto", "packed", "stream"):
        raise ValueError(
            f"weights must be 'auto', 'packed' or 'stream'; got {weights!r}")
    if kv not in ("dense", "packed"):
        raise ValueError(f"kv must be 'dense' or 'packed'; got {kv!r}")
    if kv_attention not in ("stream", "dense"):
        raise ValueError(
            f"kv_attention must be 'stream' or 'dense'; got {kv_attention!r}")
    if weights == "packed":
        raise NotImplementedError(
            "lane-packed kernel views (packed_matmul) are ROADMAP item B2; "
            "serve with weights='auto' or 'stream'")
    kvc = None
    if kv == "packed":
        kvc = state.get("packed_kv")
        if kvc is None:
            raise ValueError(
                "kv='packed' needs a PackedKVCache in state['packed_kv'] "
                "(see repro_torch.kvcache.PackedKVCache.create)")
    device = pp.device
    inv_freq = rope_freqs(cfg, device)
    b = tokens.shape[0]
    if slot_ids is not None and slot_ids.shape[0] != b:
        raise ValueError(
            f"slot_ids has {slot_ids.shape[0]} rows but tokens has {b}")
    rows = torch.arange(b, device=device) if slot_ids is None \
        else slot_ids.to(device=device, dtype=torch.int64)
    pos = state["pos"] if slot_ids is None else state["pos"][rows]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = pp.other["embed"]
    x = embed[tokens.to(device=device, dtype=torch.int64)] \
        * torch.tensor(cfg.d_model ** 0.5, dtype=embed.dtype, device=device)

    def mm(name, layer, x2d):
        return _pmm_direct(x2d.to(torch.float32), pp, name, layer,
                           plain=plain)

    for layer in range(cfg.n_layers):
        hnorm = apply_norm(cfg, {"scale": pp.other["norm1"]["scale"][layer]},
                           x)
        q = mm("attn/wq", layer, hnorm).reshape(b, 1, h, hd)
        kk = mm("attn/wk", layer, hnorm).reshape(b, 1, hkv, hd)
        vv = mm("attn/wv", layer, hnorm).reshape(b, 1, hkv, hd)
        pos_b = pos[:, None]
        q = apply_rope(q, pos_b, inv_freq)
        kk = apply_rope(kk, pos_b, inv_freq)
        if kvc is not None:
            kvc.append(kk[:, 0], vv[:, 0], pos, rows, layer=layer)
            att = stream_decode_attention(
                kvc, q.to(torch.bfloat16), pos, rows, layer=layer,
                oracle=kv_attention == "dense", plain=plain)
        else:
            kc, vc = state["k_cache"][layer], state["v_cache"][layer]
            kc[rows, pos.to(torch.int64)] = kk[:, 0].to(kc.dtype)
            vc[rows, pos.to(torch.int64)] = vv[:, 0].to(vc.dtype)
            att = decode_attention(q.to(torch.bfloat16), kc[rows], vc[rows],
                                   pos)
        y = mm("attn/wo", layer, att.reshape(b, h * hd))
        x = x + y.to(x.dtype)
        h2 = apply_norm(cfg, {"scale": pp.other["norm2"]["scale"][layer]}, x)
        g = mm("mlp/w_gate", layer, h2)
        u = mm("mlp/w_up", layer, h2)
        hh = activation(cfg.act, g) * u
        y2 = mm("mlp/w_down", layer, hh)
        x = x + y2.to(x.dtype)

    x = apply_norm(cfg, pp.other["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ embed.T
    else:
        logits = x @ pp.other["unembed"]
    new_state = dict(state)
    if slot_ids is None:
        new_state["pos"] = pos + 1
    else:
        new_state["pos"] = state["pos"].index_add(
            0, rows, torch.ones_like(pos))
    return logits, new_state


def bytes_per_token_report(cfg, pp) -> dict:
    """Weight bytes streamed per decode token: packed vs baselines."""
    n_elems = sum(k * n * cfg.n_layers for k, n in pp.shapes.values())
    other = pp.other_bytes()
    pad_bits = 8 if pp.spec.bits > 4 else (4 if pp.spec.bits > 2 else 2)
    pad_bits = max(pad_bits, 1 << (pp.spec.bits - 1).bit_length())
    return {
        "packed_MiB": (pp.stream_bytes + other) / 2**20,
        "bf16_MiB": (n_elems * 2 + other) / 2**20,
        "padded_int_MiB": (n_elems * pad_bits / 8) / 2**20,
        "quantized_elems": n_elems,
    }
