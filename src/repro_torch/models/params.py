"""Dense decoder parameters: seeded init and hand-over from the reference.

:func:`init_params` builds a parameter tree with the structure of the
reference's ``Model.init`` (``src/repro/models/model.py:49-71`` for the
dense family): ``embed``, ``blocks`` (one dict per period template entry,
every leaf stacked over layers) and ``final_norm``.  Weights are
truncated normals in f32 scaled like the reference's ``dense_init`` and
cast to the model dtype; norms are ones.  The numbers differ from the
reference's (different generators): tests hand the reference's weights
over with :func:`params_from_jax`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _dense(gen, shape, scale, dtype, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def init_params(cfg, generator: torch.Generator | None = None, *,
                device=None) -> dict:
    """Seeded dense-decoder parameters on ``device`` (``"cuda"`` unless
    given), drawn from ``generator`` (on that device; seed 0 if None)."""
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    dtype = getattr(torch, cfg.dtype)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, hkv, hd, n = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

    def dense(d_in, d_out, scale=None, layers=True):
        shape = (n, d_in, d_out) if layers else (d_in, d_out)
        return _dense(gen, shape, d_in ** -0.5 if scale is None else scale,
                      dtype, device)

    ones = torch.ones((n, d), dtype=torch.float32, device=device)
    block = {
        "norm1": {"scale": ones.clone()},
        "norm2": {"scale": ones.clone()},
        "attn": {
            "wq": dense(d, h * hd),
            "wk": dense(d, hkv * hd),
            "wv": dense(d, hkv * hd),
            "wo": dense(h * hd, d, scale=(h * hd) ** -0.5),
        },
        "mlp": {
            "w_gate": dense(d, f),
            "w_up": dense(d, f),
            "w_down": dense(f, d, scale=f ** -0.5),
        },
    }
    params = {
        "embed": dense(v, d, layers=False),
        "blocks": [block],
        "final_norm": {"scale": torch.ones((d,), dtype=torch.float32,
                                           device=device)},
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense(d, v, layers=False)
    return params


def params_from_jax(np_params, device=None):
    """The reference's parameter tree, converted to numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's tensors.

    bfloat16 arrays keep their exact bits; the tree keeps its structure.
    """
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a).copy())
        return t.to(device)

    return conv(np_params)
