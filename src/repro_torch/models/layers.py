"""Shared model building blocks: init, norms, activations, RoPE, MLP.

Port of ``src/repro/models/layers.py`` (:func:`dense_init`,
:func:`init_norm`, :func:`apply_norm`, :func:`activation`,
:func:`rope_freqs`, :func:`apply_rope` with qwen2-vl's M-RoPE,
:func:`sinusoidal_positions`, :func:`init_mlp`, :func:`apply_mlp`).
Plain functions on tensors;
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


def _pow_f32(base: float, x: torch.Tensor) -> torch.Tensor:
    """``base ** x`` for f32 exponents ``x``, taken in f64 and rounded
    once: the correctly rounded f32 values the reference's ``base ** x``
    gives.  An f32 ``pow`` is off by an ulp at some exponents, which
    moves the angles of late positions by ~1e-5."""
    return (base ** x.to(torch.float64)).to(torch.float32)


def rope_freqs(cfg, device=None) -> torch.Tensor | None:
    if not cfg.rope_theta:
        return None
    hd = cfg.head_dim
    return _pow_f32(cfg.rope_theta, -torch.arange(
        0, hd, 2, dtype=torch.float32, device=device) / hd)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor | None,
               mrope_sections: tuple[int, int, int] | None = None
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S), or (B, S, 3) for M-RoPE.
    Rotate-half RoPE in f32.

    M-RoPE (qwen2-vl, ``src/repro/models/layers.py:80-105``): the hd/2
    frequency channels are split into (temporal, height, width) sections,
    each rotated by its own position stream.  For text tokens the three
    streams are equal, which is standard RoPE."""
    if inv_freq is None:
        return x
    if positions.ndim == 2:
        positions = positions[..., None].expand(*positions.shape, 3)
    if mrope_sections is None:
        pos = positions[..., :1]                                 # (B, S, 1)
    else:
        if sum(mrope_sections) != inv_freq.shape[0]:
            raise ValueError(f"mrope_sections {mrope_sections} do not sum "
                             f"to {inv_freq.shape[0]} channels")
        pos = torch.cat([positions[..., i:i + 1].expand(
            *positions.shape[:-1], n) for i, n in enumerate(mrope_sections)],
            dim=-1)                                              # (B,S,hd/2)
    angles = pos.to(torch.float32) * inv_freq                    # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


def sinusoidal_positions(n_ctx: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table (n_ctx, d) f32."""
    inv = _pow_f32(10000, -torch.arange(0, d, 2, dtype=torch.float32,
                                        device=device) / d)
    ang = torch.arange(n_ctx, dtype=torch.float32, device=device)[:, None] \
        * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
