"""Model parameters: seeded init and hand-over from the reference.

:func:`init_params` builds a parameter tree with the structure of the
reference's ``Model.init`` (``src/repro/models/model.py:49-71``) for
every family: ``embed``, ``blocks`` (one dict per entry of the period
template, every leaf stacked over periods; see
``transformer.init_stack``), ``final_norm``, ``unembed`` when untied, and
for an encoder-decoder ``encoder`` with its own ``blocks`` and
``final_norm``.  Weights are truncated normals in f32 scaled like the
reference's ``dense_init`` and cast to the model dtype; a Mamba
sublayer's ``dt_bias`` / ``a_log`` / ``d_skip`` are f32 zeros / zeros /
ones, as in ``init_mamba``, and an RWKV sublayer's ``decay_w0`` /
``bonus_u`` / ``mix`` f32 -2 / 0 / 0.5, as in ``init_rwkv_time_mix``.
The numbers differ from the reference's (different generators): tests
hand the reference's weights over with :func:`params_from_jax`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .layers import dense_init, init_norm
from .transformer import encoder_config, init_stack


def init_params(cfg, generator: torch.Generator | None = None, *,
                device=None) -> dict:
    """Seeded parameters on ``device`` (``"cuda"`` unless given), drawn
    from ``generator`` (on that device; seed 0 if None): the blocks
    first, then ``embed``, ``unembed`` and the encoder's blocks."""
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    dtype = getattr(torch, cfg.dtype)
    params = {"blocks": init_stack(gen, cfg, device=device)}
    params["embed"] = dense_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                 device=device)
    params["final_norm"] = init_norm(cfg, cfg.d_model, device=device)
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype, device=device)
    if cfg.encoder is not None:
        params["encoder"] = {
            "blocks": init_stack(gen, encoder_config(cfg), device=device),
            "final_norm": init_norm(cfg, cfg.d_model, device=device)}
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
