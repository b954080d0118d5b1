"""The served decoder as one plain causal forward pass, computed in f32.

Pre-norm decoder layers (LayerNorm or RMSNorm), attention with grouped
KV heads and rotate-half RoPE, a gated SiLU MLP, biases on the seven
projections, and tied or untied unembedding, as the configuration file
states them.  Every projection reads the weight its int-N codes and bf16
group scales stand for (:func:`.quant.dequantized_weight`), and every
key and value is read back from its int-N cache form
(:func:`.quant.kv_round`).  With text positions the three position
streams of M-RoPE are equal, so M-RoPE is RoPE over the whole rotary
width.

Every operation is f32 (TF32 off).  ``act`` is the type the model keeps
its activations in between operations, as the configuration's
``torch_dtype`` states it: the residual stream, each norm's output (the
projections' input), the query, the keys and values as attention reads
them, the attention's output, and each projection's output as it joins
the residual.  Each is rounded to ``act`` where it is kept, as weights
are rounded to their codes; the projections' f32 outputs inside a
sublayer (q, k, v before RoPE and the cache, the MLP's gate and up) and
the logits stay f32.  The control is ``act="float8_e4m3fn"``, the step
below bf16, with one f32 scale per row as fp8 is kept.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .quant import dequantized_weight, fp8_round, kv_round

#: the types activations may be kept in
ACTS = ("bfloat16", "float8_e4m3fn")


def keeper(act: str):
    """The rounding of a kept activation of type ``act``."""
    if act == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    if act == "float8_e4m3fn":
        return fp8_round
    raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def _norm(shape, p: dict, x: torch.Tensor) -> torch.Tensor:
    scale = p["scale"].to(torch.float32)
    if shape.norm == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + shape.norm_eps) * scale \
            + p["bias"].to(torch.float32)
    ms = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + shape.norm_eps) * scale


def _rope(x: torch.Tensor, shape) -> torch.Tensor:
    """Rotate-half RoPE over the first ``rotary_dim`` channels of each
    head; ``x``: (B, T, H, hd), positions 0..T-1."""
    rd = shape.rotary_dim
    if rd == 0:
        return x
    t = x.shape[1]
    inv = shape.rope_theta ** (-torch.arange(0, rd, 2, dtype=torch.float64,
                                             device=x.device) / rd)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(torch.float32)[None, :, None, :]
    sin = torch.sin(ang).to(torch.float32)[None, :, None, :]
    rot, rest = x[..., :rd], x[..., rd:]
    x1, x2 = rot.chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rot, rest], dim=-1)


def served_logits(shape, quant, weights: dict, seqs: list[list[int]],
                  starts: list[int], *, act: str = "bfloat16"
                  ) -> list[torch.Tensor]:
    """f32 logits of each sequence at positions ``starts[i]`` to its end.

    ``shape``: the model's sizes (:class:`perfbench.spec.ModelShape`);
    ``quant``: ``weight_bits``, ``group_size``, ``kv_bits``;
    ``weights``: the seeded bf16 tensors (:mod:`perfbench.weights`),
    every per-layer leaf stacked over layers.  All sequences run as one
    batch, padded at the end (causal attention keeps padding out of the
    positions read), one layer after the other.
    """
    keep = keeper(act)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward(shape, quant, weights, seqs, starts, keep)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _forward(shape, quant, weights, seqs, starts, keep):
    dev = weights["embed"].device
    b, t = len(seqs), max(len(s) for s in seqs)
    tok = torch.zeros((b, t), dtype=torch.int64, device=dev)
    for i, s in enumerate(seqs):
        tok[i, :len(s)] = torch.as_tensor(s, dtype=torch.int64)
    h, hkv, hd = shape.n_heads, shape.n_kv_heads, shape.head_dim
    lay = weights["layers"]
    kv_bits = quant["kv_bits"]

    def proj(x, name, layer):
        w = dequantized_weight(lay[name][layer], quant["weight_bits"],
                               quant["group_size"])
        y = x @ w
        bias = lay.get("b" + name[1:])          # wq -> bq, w_up -> b_up
        return y if bias is None else y + bias[layer].to(torch.float32)

    def norm(name, layer, x):
        return keep(_norm(shape, {k: v[layer] for k, v in lay[name].items()},
                          x))

    x = keep(weights["embed"][tok].to(torch.float32)
             * shape.embedding_multiplier)
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    for layer in range(shape.n_layers):
        a = norm("norm1", layer, x)
        q = keep(_rope(proj(a, "wq", layer).reshape(b, t, h, hd), shape))
        k = _rope(proj(a, "wk", layer).reshape(b, t, hkv, hd), shape)
        v = proj(a, "wv", layer).reshape(b, t, hkv, hd)
        k = keep(kv_round(k, kv_bits)).repeat_interleave(h // hkv, dim=2)
        v = keep(kv_round(v, kv_bits)).repeat_interleave(h // hkv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        o = keep(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v))
        x = keep(x + keep(proj(o.reshape(b, t, h * hd), "wo", layer)))
        m = norm("norm2", layer, x)
        g = proj(m, "w_gate", layer)
        u = proj(m, "w_up", layer)
        x = keep(x + keep(proj(F.silu(g) * u, "w_down", layer)))
    x = keep(_norm(shape, weights["final_norm"], x))
    unembed = weights["embed"].T if shape.tie_word_embeddings \
        else weights["unembed"]
    unembed = unembed.to(torch.float32)
    return [x[i, starts[i]:len(s)] @ unembed for i, s in enumerate(seqs)]
