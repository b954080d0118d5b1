"""Shared model building blocks: norms, activations, RoPE.

Port of ``src/repro/models/layers.py:27-107`` (:func:`apply_norm`,
:func:`activation`, :func:`rope_freqs`, :func:`apply_rope`; M-RoPE is
left out with the VLM family).  Plain functions on tensors; parameters
are plain dicts, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
