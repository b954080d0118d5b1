"""Shared model building blocks: init, norms, activations, RoPE, MLP.

Port of ``src/repro/models/layers.py`` (:func:`dense_init`,
:func:`init_norm`, :func:`apply_norm`, :func:`activation`,
:func:`rope_freqs`, :func:`apply_rope`, :func:`init_mlp`,
:func:`apply_mlp`; M-RoPE and the sinusoidal table are left out with the
VLM and encoder-decoder families).  Plain functions on tensors;
parameters are plain dicts, as in the reference.  The init functions take
a ``torch.Generator`` and a leading shape ``lead`` (the stacking over
periods that the reference gets from ``vmap``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               lead: tuple = (), scale: float | None = None,
               device=None) -> torch.Tensor:
    """Truncated normal in [-2, 2] drawn in f32, times ``scale``
    (``d_in ** -0.5`` by default), cast to ``dtype``: shape
    ``lead + (d_in, d_out)``."""
    scale = d_in ** -0.5 if scale is None else scale
    t = torch.empty(lead + (d_in, d_out), dtype=torch.float32,
                    device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def init_norm(cfg, d: int, *, lead: tuple = (), device=None) -> dict:
    p = {"scale": torch.ones(lead + (d,), dtype=torch.float32,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=torch.float32,
                                device=device)
    return p


def apply_norm(cfg, p: dict, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    """RMSNorm (or LayerNorm) in f32, returned in ``x``'s dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu_squared":
        return torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def rope_freqs(cfg, device=None) -> torch.Tensor | None:
    if not cfg.rope_theta:
        return None
    hd = cfg.head_dim
    return cfg.rope_theta ** (
        -torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor | None) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S).  Rotate-half RoPE in f32."""
    if inv_freq is None:
        return x
    angles = positions[..., None].to(torch.float32) * inv_freq   # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


def init_mlp(gen: torch.Generator, cfg, *, d_ff: int | None = None,
             lead: tuple = (), device=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dtype = getattr(torch, cfg.dtype)
    p = {
        "w_gate": dense_init(gen, d, f, dtype, lead=lead, device=device),
        "w_up": dense_init(gen, d, f, dtype, lead=lead, device=device),
        "w_down": dense_init(gen, f, d, dtype, lead=lead, scale=f ** -0.5,
                             device=device),
    }
    if cfg.use_bias:
        for name, n in (("b_gate", f), ("b_up", f), ("b_down", d)):
            p[name] = torch.zeros(lead + (n,), dtype=dtype, device=device)
    return p


def apply_mlp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    if cfg.use_bias:
        g = g + p["b_gate"]
        u = u + p["b_up"]
    h = activation(cfg.act, g) * u
    y = h @ p["w_down"]
    if cfg.use_bias:
        y = y + p["b_down"]
    return y
