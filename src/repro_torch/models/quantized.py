"""Quantized decode path: serve from Iris-packed weight streams.

Port of ``src/repro/models/quantized.py:38-43, 73-293``:
:func:`quantizable`, :func:`_pmm`, :func:`_pmm_direct`,
:func:`packed_decode_step` (``weights``, ``slot_ids``, ``stream_source``,
``kv``, ``kv_attention``) and :func:`bytes_per_token_report`.  A weight matmul
reads the tree's lane-packed kernel views (``packed_matmul``), or gathers
codes and scales straight out of the layer's packed stream
(``stream_matmul``), routed as the reference routes them; with
``kv="packed"`` the KV cache is an Iris-planned packed stream too, read
by ``stream_attention``.  A ``use_bias`` config adds the reference's seven
biases (``bq``/``bk``/``bv`` before RoPE, ``bo``, ``b_gate``/``b_up``
before the activation, ``b_down``), dense leaves of ``pp.other``; norms
take the layer's whole norm dict (a LayerNorm's bias too).  The final
``logits = x @ embed.T`` is a plain product outside any kernel and stays
``torch.matmul``.

State is a dict of tensors: ``pos`` (B,) int32, plus ``k_cache`` /
``v_cache`` (dense KV) or ``packed_kv`` (a
:class:`~repro_torch.kvcache.PackedKVCache`).  Unlike the reference the
caches are updated **in place**; the returned state holds the same cache
objects and a new ``pos``.
"""
from __future__ import annotations

import torch

from .. import obs
from ..kernels.packed_matmul import packed_matmul, packed_matmul_plain
from .attention import decode_attention, stream_decode_attention
from .layers import activation, apply_norm, apply_rope, rope_freqs
from .transformer import period_template


def quantizable(cfg) -> bool:
    """The packed decode path covers the dense sublayer template: one
    ``attn -> mlp`` sublayer a period, without cross-attention (the dense
    family and qwen2-vl)."""
    t = period_template(cfg)
    return (len(t) == 1 and t[0].mixer == "attn" and t[0].ffn == "mlp"
            and not t[0].cross)


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


def _pmm(x2d: torch.Tensor, pw: torch.Tensor, sc: torch.Tensor, spec, *,
         plain: bool = False) -> torch.Tensor:
    """``x2d @ dequant(pw, sc)`` over one layer's lane-packed kernel view.
    The kernel takes any M, and any K and N the function is defined for,
    so unlike the reference no rows are padded and no Pallas block sizes
    are chosen here."""
    fn = packed_matmul_plain if plain else packed_matmul
    return fn(x2d, pw, sc, bits=spec.bits, group_size=spec.group_size)


def _pmm_direct(x2d: torch.Tensor, pp, name: str, layer: int, *,
                words: torch.Tensor | None = None,
                plain: bool = False) -> torch.Tensor:
    """Stream-direct ``x2d @ dequant(name)`` for layer ``layer``, from
    ``words`` when given (else the tree's resident stream)."""
    return pp.matmul_direct(x2d, name, layer, words=words, plain=plain)


def packed_decode_step(cfg, pp, state: dict, tokens: torch.Tensor, *,
                       weights: str = "auto", slot_ids=None,
                       stream_source=None,
                       kv: str = "dense", kv_attention: str = "stream",
                       plain: bool = False
                       ) -> tuple[torch.Tensor, dict]:
    """One decode token with dequant-on-load weights (dense archs).

    ``weights``: ``"packed"`` reads the lane-packed kernel views
    (``packed_matmul``; bits in ``SUPPORTED_BITS`` only), ``"stream"``
    gathers straight from the per-layer streams (``stream_matmul``, any
    width), ``"auto"`` takes the views when the tree has them and the
    streams otherwise.
    ``slot_ids``: the active cache rows aligned with ``tokens`` (ragged
    M); ``None`` steps every row.  ``stream_source`` (stream path only)
    maps a layer index to that layer's u32 stream words on the device —
    e.g. a :class:`~repro_torch.engine.streams.StreamUploader` staging
    uploads ahead of compute; ``None`` reads the tree's resident
    buffers.  ``kv``: ``"dense"`` bf16 caches or
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
    pp = pp.gathered()              # a placed tree: its whole leaves
    use_stream = weights == "stream" or (weights == "auto" and not pp.packed)
    if weights == "packed" and not pp.packed:
        raise ValueError(
            "tree has no lane-packed kernel views (built with "
            "with_kernel_views=False); serve with weights='stream'")
    if stream_source is not None and not use_stream:
        raise ValueError(
            "stream_source only applies to the stream-direct path "
            "(weights='stream', or 'auto' on a kernel-view-free tree)")
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

    mm_span = "matmul.stream" if use_stream else "matmul.packed"

    def mm(name, layer, x2d):
        with obs.span(mm_span, w=name, layer=layer):
            if use_stream:
                return _pmm_direct(x2d.to(torch.float32), pp, name, layer,
                                   words=words, plain=plain)
            return _pmm(x2d.to(torch.float32), pp.packed[name][layer],
                        pp.scales[name][layer], pp.spec, plain=plain)

    other = pp.other

    def norm(name, layer):
        return {k: v[layer] for k, v in other[name].items()}

    for layer in range(cfg.n_layers):
        words = stream_source(layer) if stream_source is not None else None
        hnorm = apply_norm(cfg, norm("norm1", layer), x)
        q = mm("attn/wq", layer, hnorm).reshape(b, 1, h, hd)
        kk = mm("attn/wk", layer, hnorm).reshape(b, 1, hkv, hd)
        vv = mm("attn/wv", layer, hnorm).reshape(b, 1, hkv, hd)
        if cfg.use_bias:
            q = q + other["attn/bq"][layer].reshape(1, 1, h, hd)
            kk = kk + other["attn/bk"][layer].reshape(1, 1, hkv, hd)
            vv = vv + other["attn/bv"][layer].reshape(1, 1, hkv, hd)
        pos_b = pos[:, None]
        q = apply_rope(q, pos_b, inv_freq, cfg.mrope_sections)
        kk = apply_rope(kk, pos_b, inv_freq, cfg.mrope_sections)
        if kvc is not None:
            kvc.append(kk[:, 0], vv[:, 0], pos, rows, layer=layer)
            with obs.span("attention", layer=layer):
                att = stream_decode_attention(
                    kvc, q.to(torch.bfloat16), pos, rows, layer=layer,
                    oracle=kv_attention == "dense", plain=plain)
        else:
            kc, vc = state["k_cache"][layer], state["v_cache"][layer]
            kc[rows, pos.to(torch.int64)] = kk[:, 0].to(kc.dtype)
            vc[rows, pos.to(torch.int64)] = vv[:, 0].to(vc.dtype)
            with obs.span("attention", layer=layer):
                att = decode_attention(q.to(torch.bfloat16), kc[rows],
                                       vc[rows], pos)
        y = mm("attn/wo", layer, att.reshape(b, h * hd))
        if cfg.use_bias:
            y = y + other["attn/bo"][layer]
        x = x + y.to(x.dtype)
        h2 = apply_norm(cfg, norm("norm2", layer), x)
        g = mm("mlp/w_gate", layer, h2)
        u = mm("mlp/w_up", layer, h2)
        if cfg.use_bias:
            g = g + other["mlp/b_gate"][layer]
            u = u + other["mlp/b_up"][layer]
        hh = activation(cfg.act, g) * u
        y2 = mm("mlp/w_down", layer, hh)
        if cfg.use_bias:
            y2 = y2 + other["mlp/b_down"][layer]
        x = x + y2.to(x.dtype)

    with obs.span("logits"):
        x = apply_norm(cfg, other["final_norm"], x)
        if cfg.tie_embeddings:
            logits = x @ embed.T
        else:
            logits = x @ other["unembed"]
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
    if pp.packed:
        # the serving view: lane-packed codes, scales and dense leaves
        packed_b = other + sum(
            v.numel() * 4 for v in pp.packed.values()) + sum(
            v.numel() * v.element_size() for v in pp.scales.values())
    else:
        # stream-direct: the per-layer stream is the weight storage
        packed_b = pp.stream_bytes + other
    pad_bits = 8 if pp.spec.bits > 4 else (4 if pp.spec.bits > 2 else 2)
    pad_bits = max(pad_bits, 1 << (pp.spec.bits - 1).bit_length())
    return {
        "packed_MiB": packed_b / 2**20,
        "bf16_MiB": (n_elems * 2 + other) / 2**20,
        "padded_int_MiB": (n_elems * pad_bits / 8) / 2**20,
        "quantized_elems": n_elems,
    }
