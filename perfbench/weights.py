"""Seeded weights of a served model, made on the device in bf16.

One ``randn`` per leaf kind, every layer's leaf at once, from a
``torch.Generator`` on the device seeded with the run's ``--seed``: the
same seed gives the same weights, on the program's side before the
window and on the reference's after it.  Scales keep activations of
order one through the depth: projections ``N(0, 1/K)``, the untied
unembedding ``N(0, 1/d)`` (logits of order one), norm scales
``1 + N(0, 0.1^2)``, norm shifts and biases ``N(0, 0.1^2)``.

The embedding is drawn at a quarter of that scale, ``N(0, 1/(16 d))``
(the model multiplies it by ``sqrt(d)``), and a tied model's final norm
scales by 4 to give its logits back their order one.  At the full scale a
tied model's residual keeps so much of the current token's embedding that
that token's logit tops every other by a wide margin and greedy decoding
repeats it: every position would be an easy call, and the comparison
that decides ``correct`` would read nothing.
"""
from __future__ import annotations

import torch

NOISE_STD = 0.1
#: the embedding's scale against ``N(0, 1/d)``; a tied model's final norm
#: takes its inverse
EMBED_GAIN = 0.25


def make_weights(shape, seed: int, device) -> dict:
    """``{"embed", "unembed" (untied only), "final_norm", "layers"}``;
    ``layers`` holds each projection stacked as ``(L, K, N)``, its bias
    as ``(L, N)`` and the two norms as ``{"scale", "bias"}`` of ``(L, d)``
    (``bias`` for LayerNorm only)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bf = torch.bfloat16
    L, d, v = shape.n_layers, shape.d_model, shape.vocab_size

    def normal(size, std, mean=0.0):
        t = torch.randn(size, generator=gen, dtype=bf, device=device)
        t.mul_(std)
        return t.add_(mean) if mean else t

    def norm(lead, gain=1.0):
        p = {"scale": normal(lead + (d,), NOISE_STD * gain, gain)}
        if shape.norm == "layernorm":
            p["bias"] = normal(lead + (d,), NOISE_STD)
        return p

    layers = {"norm1": norm((L,)), "norm2": norm((L,))}
    for name, k, n in shape.linears():
        layers[name] = normal((L, k, n), k ** -0.5)
        if shape.linear_bias:
            layers["b" + name[1:]] = normal((L, n), NOISE_STD)
    tied = shape.tie_word_embeddings
    out = {"layers": layers, "embed": normal((v, d), EMBED_GAIN * d ** -0.5),
           "final_norm": norm((), 1 / EMBED_GAIN if tied else 1.0)}
    if not tied:
        out["unembed"] = normal((d, v), d ** -0.5)
    return out


def port_params(weights: dict) -> dict:
    """The same tensors arranged as the program's parameter tree (one
    stacked sublayer: ``blocks[0]`` with ``attn``, ``mlp``, ``norm1``,
    ``norm2``)."""
    lay = weights["layers"]
    attn = {k: lay[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                                "bo") if k in lay}
    mlp = {k: lay[k] for k in ("w_gate", "w_up", "w_down", "b_gate", "b_up",
                               "b_down") if k in lay}
    params = {"blocks": [{"attn": attn, "mlp": mlp, "norm1": lay["norm1"],
                          "norm2": lay["norm2"]}],
              "embed": weights["embed"], "final_norm": weights["final_norm"]}
    if "unembed" in weights:
        params["unembed"] = weights["unembed"]
    return params
