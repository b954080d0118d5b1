"""Gradient compression for a cross-pod all-reduce: int8 with error
feedback.

Port of ``src/repro/optim/compression.py``: :class:`GradCompressor` with
``init_state``, ``_quantize``, ``_dequantize``, ``compress_decompress``
and ``wire_bytes``, over the port's dict trees of tensors.  Each leaf,
corrected by its error-feedback residual, is flattened, padded to a
multiple of ``block`` and quantized to int8 with one f32 scale per block
(``amax / 127``, 1 for an all-zero block); the residual keeps what the
round trip lost, so the compression is unbiased over time.

The reference runs this as the jitted train step's ``transform_grads``,
and XLA compiles two of its expressions otherwise than they read; the
port computes the jitted forms, so its codes, scales, gradients and
residuals are the jitted reference's bit for bit:

* ``amax / 127.0`` is a multiply by the f32 reciprocal ``1/127`` (the
  eager reference divides and differs in the last bit of some scales);
* the residual ``corrected - q * scale`` is one fused multiply-add, with
  no rounding of the product.  The port subtracts in f64: ``q * scale``
  (7 x 24 bits) is exact there, and so is the difference (the two
  operands lie within a factor 2 of each other, or ``q`` is 0), so its
  one rounding to f32 is the FMA's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..pytree import flatten, tree_map, unflatten

#: f32(1/127): XLA's form of the reference's ``amax / 127.0``
_INV_127 = float(np.float32(1.0 / 127.0))


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    block: int = 256          # elements per scale block

    def init_state(self, grads: Any) -> Any:
        """Error-feedback residual, same structure as grads (f32)."""
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    def _quantize(self, g: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """(int8 codes (n_blocks, block), f32 scales (n_blocks, 1), the
        leaf's element count)."""
        flat = g.to(torch.float32).reshape(-1)
        n = flat.shape[0]
        flat = F.pad(flat, (0, -n % self.block)).reshape(-1, self.block)
        amax = torch.amax(torch.abs(flat), dim=1, keepdim=True)
        scale = torch.where(amax > 0, amax * _INV_127,
                            torch.ones_like(amax))
        q = torch.clamp(torch.round(flat / scale), -127, 127) \
            .to(torch.int8)
        return q, scale, n

    def _dequantize(self, q: torch.Tensor, scale: torch.Tensor, n: int,
                    shape) -> torch.Tensor:
        """``q * scale`` in the scale's dtype (f32; f64 for the exact
        product of the residual), the padding dropped."""
        return (q.to(scale.dtype) * scale).reshape(-1)[:n].reshape(shape)

    def compress_decompress(self, grads: Any, ef_state: Any
                            ) -> tuple[Any, Any]:
        """Returns (decompressed grads, new error-feedback state)."""
        def per_leaf(g, ef):
            corrected = g.to(torch.float32) + ef
            q, scale, n = self._quantize(corrected)
            deq = self._dequantize(q, scale, n, g.shape)
            exact = self._dequantize(q.to(torch.float64),
                                     scale.to(torch.float64), n, g.shape)
            new_ef = (corrected.to(torch.float64) - exact) \
                .to(torch.float32)
            return deq.to(g.dtype), new_ef

        outs = [per_leaf(g, e)
                for g, e in zip(flatten(grads), flatten(ef_state))]
        return (unflatten(grads, [o[0] for o in outs]),
                unflatten(grads, [o[1] for o in outs]))

    def wire_bytes(self, grads: Any) -> tuple[int, int]:
        """(compressed, uncompressed-f32) bytes for one reduction."""
        leaves = flatten(grads)
        n = sum(g.numel() for g in leaves)
        blocks = sum(-(-g.numel() // self.block) for g in leaves)
        return n + 4 * blocks, 4 * n
