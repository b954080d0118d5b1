"""Device choice for the port's entry points.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``
(the CPU runs the kernels' plain PyTorch versions, as the tests do).
Without a CUDA device and without an explicit device they raise: the
port never drops to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions instead")
        return torch.device("cuda")
    return torch.device(device)
