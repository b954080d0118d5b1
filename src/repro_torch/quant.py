"""Custom-precision integer weight quantization.

Own copy of ``src/repro/quant/qtypes.py:26-136`` (:class:`QuantSpec`,
:func:`quantize`, :func:`dequantize`, the lane-packed u32 storage
:func:`pack_codes_u32` / :func:`unpack_codes_u32` that ``packed_matmul``
reads, :func:`quant_error_bound` and :func:`codes_as_numpy_elements`)
in PyTorch.  Symmetric, group-wise
along K, biased unsigned codes (``q + 2^(bits-1)``) and bf16 scales.

Codes and bf16 scale bit patterns are bit-identical to the reference:
the arithmetic is f32, ``torch.round`` rounds half to even like
``jnp.round``, and the f32 -> bf16 cast rounds to nearest even on both
backends.  The reference's ``quantize`` is jitted, and XLA rewrites its
division by the constant ``qmax`` as a multiply by the f32 reciprocal
``1/qmax``; the port computes the scale the same way.  The per-element
``w / scale`` is a true division in both.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kernels.ref import to_int32_bits, unpack_lanes


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    bits: int = 4            # element width W
    group_size: int = 128    # contraction elements sharing one scale
    scale_dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if not 2 <= self.bits <= 8:
            raise ValueError(f"bits must be in [2, 8], got {self.bits}")
        if self.group_size <= 0:
            raise ValueError("group_size must be positive")

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def bias(self) -> int:
        return 1 << (self.bits - 1)


@dataclasses.dataclass
class QuantizedTensor:
    """Biased unsigned codes + per-(group, out-channel) scales."""

    codes: torch.Tensor      # (..., K, N) uint8
    scales: torch.Tensor     # (..., K // group_size, N) bfloat16
    spec: QuantSpec
    shape: tuple[int, int]


def quantize(w: torch.Tensor, spec: QuantSpec) -> QuantizedTensor:
    """Quantize ``(..., K, N)`` weights group-wise along K (the
    contraction dim); leading dims (e.g. layers) are batched."""
    *lead, k, n = w.shape
    if k % spec.group_size != 0:
        raise ValueError(f"K={k} not divisible by group_size={spec.group_size}")
    g = k // spec.group_size
    wg = w.to(torch.float32).reshape(*lead, g, spec.group_size, n)
    amax = wg.abs().amax(dim=-2)                               # (..., g, n)
    # amax * f32(1/qmax): XLA's form of the reference's ``amax / qmax``
    inv_qmax = float(np.float32(1.0 / spec.qmax))
    scale = torch.where(amax > 0, amax * inv_qmax, torch.ones_like(amax))
    q = torch.round(wg / scale.unsqueeze(-2))
    q = torch.clamp(q, -spec.qmax, spec.qmax)
    codes = (q + spec.bias).to(torch.uint8).reshape(*lead, k, n)
    return QuantizedTensor(codes=codes,
                           scales=scale.to(getattr(torch, spec.scale_dtype)),
                           spec=spec, shape=(k, n))


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """``(..., K, N)`` f32 weights from codes and the stored scales."""
    k, n = qt.shape
    g = k // qt.spec.group_size
    lead = qt.codes.shape[:-2]
    q = qt.codes.to(torch.float32) - qt.spec.bias
    q = q.reshape(*lead, g, qt.spec.group_size, n)
    w = q * qt.scales.to(torch.float32).unsqueeze(-2)
    return w.reshape(*lead, k, n)


def bits16(x: torch.Tensor) -> torch.Tensor:
    """Bit pattern of a 16-bit float tensor as int32 values in [0, 2^16)."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        x = x.to(torch.bfloat16)
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def from_bits16(pat: torch.Tensor, dtype: str) -> torch.Tensor:
    """Inverse of :func:`bits16`: integer bit patterns in [0, 2^16) ->
    the 16-bit float tensor ``dtype`` ("bfloat16" or "float16")."""
    pat = pat.to(torch.int32)
    signed = torch.where(pat >= 1 << 15, pat - (1 << 16), pat)
    return signed.to(torch.int16).view(getattr(torch, dtype))


def pack_codes_u32(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """``(..., K, N)`` codes -> ``(..., K / lanes, N)`` lane-packed u32
    words (as int32 bits), lanes = 32 / bits.

    Lane ``l`` of word ``r`` holds code ``codes[r * lanes + l]`` at bit
    ``l * bits`` (LSB first), the Iris bus convention.  Needs
    ``32 % bits == 0`` (bits in {2, 4, 8}).
    """
    if 32 % bits != 0:
        raise ValueError(f"lane packing needs 32 % bits == 0, got {bits}")
    lanes = 32 // bits
    *lead, k, n = codes.shape
    if k % lanes != 0:
        raise ValueError(f"K={k} not divisible by lanes={lanes}")
    c = codes.to(torch.int64).reshape(*lead, k // lanes, lanes, n)
    shifts = torch.arange(lanes, device=c.device).reshape(lanes, 1) * bits
    # the lanes' bits are disjoint, so the sum is their OR
    return to_int32_bits((c << shifts).sum(dim=-2))


def unpack_codes_u32(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes_u32` -> ``(..., K, N)`` uint8 codes."""
    return unpack_lanes(packed, bits).to(torch.uint8)


def quant_error_bound(spec: QuantSpec) -> float:
    """Half an LSB of the symmetric grid, in units of the group amax
    (``src/repro/quant/qtypes.py:129``)."""
    return 0.5 / spec.qmax


def codes_as_numpy_elements(qt: QuantizedTensor) -> np.ndarray:
    """Flatten codes to a uint64 element stream for the Iris packer
    (``src/repro/quant/qtypes.py:134``)."""
    return qt.codes.detach().cpu().numpy().reshape(-1).astype(np.uint64)
