"""``ssd_scan``: the scalar-decay linear-attention scan of the Mamba prefill.

Port of the TPU kernel ``src/repro/kernels/linear_scan.py:ssd_scan`` as
the hand-written CUDA kernel ``csrc/ssd_scan.cu`` (see its header for
what bounds it on an H100 and how its design answers that).  Per
(batch, head), with a scalar decay ``a_t = exp(logw_t)``::

    S_t = a_t S_{t-1} + k_t^T v_t,     o_t = q_t S_t

— the function that ``models.linear_attention.recurrent_scan`` computes
for a decay of shape (B, T, H, 1), which is what the Mamba layer runs.

:func:`ssd_scan` is the wrapper: for CPU tensors it runs the plain version
:func:`ssd_scan_plain` (``kernels/ref.ssd_scan_plain``, the reference's
chunked closed form); for CUDA tensors it launches the kernel on the
current stream or raises.  It never falls back.  ``launches`` counts
kernel launches.  Beyond the reference's signature it takes ``state0`` and
returns the final state on request (what ``recurrent_scan`` returns), and
it takes any T: the plain version pads T to a multiple of ``chunk`` with
zero q/k/v and zero ``logw`` (decay 1 leaves the state exact) and slices
the output back; the kernel masks the ragged rows the same way without a
copy.  With ``state0=None`` and T a multiple of ``chunk`` the output is
the reference ``ssd_scan``'s.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ssd_scan_plain

__all__ = ["MAX_CHUNK", "MAX_DIM", "launches", "ssd_scan", "ssd_scan_plain"]

#: the kernel's limits: chunk length (its C x C score tile lives in shared
#: memory) and head widths dk, dv
MAX_CHUNK = 128
MAX_DIM = 64

#: kernel launches made by :func:`ssd_scan`
launches = 0


def _check(q, k, v, logw, chunk, state0):
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 \
            or v.shape[:3] != q.shape[:3] or logw.shape != q.shape[:3]:
        raise ValueError(
            f"expected q/k (B, T, H, dk), v (B, T, H, dv), logw (B, T, H); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(logw.shape)}")
    b, _, h, dk = q.shape
    dv = v.shape[-1]
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}]; got {chunk}")
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"dk={dk} and dv={dv} must be in [1, {MAX_DIM}]")
    if k.dtype != q.dtype or v.dtype != q.dtype \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share dtype float32 or bfloat16; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32:
        raise ValueError(f"logw must be float32; got {logw.dtype}")
    if state0 is not None and (tuple(state0.shape) != (b, h, dk, dv)
                               or state0.dtype != torch.float32):
        raise ValueError(f"state0 must be float32 {(b, h, dk, dv)}; got "
                         f"{state0.dtype} {tuple(state0.shape)}")
    tensors = (q, k, v, logw) + (() if state0 is None else (state0,))
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, *, chunk: int = 128,
             state0: torch.Tensor | None = None,
             return_state: bool = False):
    """q/k: (B, T, H, dk), v: (B, T, H, dv) (float32 or bfloat16, one
    dtype), logw: (B, T, H) float32 (<= 0), state0: (B, H, dk, dv)
    float32 or None (zeros).  Returns out (B, T, H, dv) in q's dtype, and
    with ``return_state`` also the final state (B, H, dk, dv) float32."""
    global launches
    _check(q, k, v, logw, chunk, state0)
    if q.device.type == "cpu":
        return ssd_scan_plain(q, k, v, logw, chunk=chunk, state0=state0,
                              return_state=return_state)
    if q.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {q.device}")
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    # the kernel reads q/k/v/logw through their (b, t, h) strides; the
    # last dimension of q/k/v must be dense
    q, k, v = (a if a.stride(-1) == 1 else a.contiguous() for a in (q, k, v))
    out = torch.empty((b, t, h, dv), dtype=q.dtype, device=q.device)
    final = torch.empty((b, h, dk, dv), dtype=torch.float32,
                        device=q.device) if return_state else None
    if state0 is not None:
        state0 = state0.contiguous()
    if b * t * h:
        strides = (ctypes.c_longlong * 12)(
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *logw.stride())
        fn = build.function("ssd_scan", "ssd_scan",
                            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p])
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                None if state0 is None else state0.data_ptr(),
                out.data_ptr(), None if final is None else final.data_ptr(),
                b, t, h, dk, dv, chunk, ctypes.addressof(strides),
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
        build.check_launch("ssd_scan", rc)
        launches += 1
    elif final is not None and state0 is not None:
        final.copy_(state0)
    elif final is not None:
        final.zero_()
    return (out, final) if return_state else out
