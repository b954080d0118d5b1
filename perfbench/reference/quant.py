"""Group-wise weight quantization and per-vector KV rounding, in plain f32.

Both follow the served formats as the configuration states them:

* weights: symmetric along the contraction dim in groups of
  ``group_size``, ``scale = amax * f32(1 / qmax)``, codes
  ``round_half_even(w / scale)`` clamped to ``[-qmax, qmax]``, the scale
  stored in bf16 and the weight read back as ``code * bf16(scale)``;
* KV: symmetric per head vector (``head_dim`` values), ``scale = amax /
  qmax`` stored in bf16, read back as ``code * bf16(scale)``.
"""
from __future__ import annotations

import numpy as np
import torch


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def dequantized_weight(w: torch.Tensor, bits: int, group_size: int
                       ) -> torch.Tensor:
    """``(K, N)`` weight -> the f32 ``(K, N)`` weight its int-``bits``
    codes and bf16 group scales stand for."""
    k, n = w.shape
    if k % group_size:
        raise ValueError(f"K={k} is not a multiple of group {group_size}")
    wg = w.to(torch.float32).reshape(k // group_size, group_size, n)
    amax = wg.abs().amax(dim=1)
    qmax = _qmax(bits)
    inv = float(np.float32(1.0 / qmax))
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    codes = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax, qmax)
    stored = scale.to(torch.bfloat16).to(torch.float32)
    return (codes * stored[:, None, :]).reshape(k, n)


def kv_round(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``(..., head_dim)`` f32 keys or values -> what the int-``bits``
    cache gives back for them."""
    qmax = float(_qmax(bits))
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    codes = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return codes * scale.to(torch.bfloat16).to(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one f32 scale per row (the last
    dim), as an fp8 matrix product takes its inputs: the control's
    precision, one step below the served bf16 activations."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
