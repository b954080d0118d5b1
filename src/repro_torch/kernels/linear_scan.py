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
the reference ``ssd_scan``'s.  The function does not depend on
``chunk``: the plain version takes it as given, and the kernel walks T in
its own tile (:func:`scan_launch`), so any ``chunk`` >= 1 is taken.

Gradients.  The kernel writes a fresh tensor, outside autograd.  So when
grad is enabled and any of q, k, v, logw or state0 requires grad,
:func:`ssd_scan` is the ``apply`` of :class:`_SSDScan`: its forward is
the same launch (or the plain version on the CPU), and its backward
recomputes :func:`ssd_scan_plain` on the saved inputs under autograd and
returns its gradients for ``out`` and, with ``return_state``, the final
state.  The plain version masks before its ``exp``, so its gradient has
no NaN.  There is no CUDA backward kernel (the reference has no Pallas
backward either); a backward through the card's forward costs one plain
recompute.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ssd_scan_plain

__all__ = ["MAX_DIM", "launches", "scan_launch", "ssd_scan",
           "ssd_scan_plain"]

#: the widest q/k (dk) and v (dv) head the kernel takes
MAX_DIM = 256
#: dynamic shared memory one block may use on an H100
MAX_SMEM = 227 * 1024
#: the kernel's row pad of its shared tiles (PAD in the .cu)
_PAD = 8
#: warps of a kernel block (WARPS in the .cu)
_WARPS = 8

#: kernel launches made by :func:`ssd_scan`
launches = 0

#: the C launch function's argument types
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def scan_smem(tile: int, dvs: int, dk: int, elem_bytes: int) -> int:
    """Shared memory of one kernel block in bytes (``smem_bytes`` in the
    .cu).  In the inputs' dtype: two stages of the copied q, k ``(tile,
    dk)`` and v ``(tile, dvs)`` tiles, and the block's ``v^T``.  In bf16
    hi/lo pairs: ``(k W)^T``, the score tile and the block's slice of
    ``S^T``, one per chunk parity (its f32 value lives in registers); two
    stages of logw and three f32 vectors of ``tile``.  Rows padded to a
    multiple of 16, plus 8."""
    dkp = _round16(dk)
    lq, lc, lvn = dkp + _PAD, tile + _PAD, dvs + _PAD
    return (elem_bytes * (2 * tile * (2 * lq + lvn) + dvs * lc)
            + 4 * (dkp * lc + tile * lc + 2 * dvs * lq + 5 * tile))


def scan_launch(b: int, h: int, dk: int, dv: int,
                elem_bytes: int) -> tuple[int, int, int]:
    """Launch shape of the ``ssd_scan`` kernel: ``(tile, dvs, smem)``.

    One block of 8 warps per (batch, head, slice of ``dvs`` columns of
    v), walking the sequence in chunks of ``tile`` tokens (the function
    does not depend on the chunk, so this need not be the caller's).  A
    warp keeps one 16 x 64 strip of the slice's state in registers, so a
    slice has at most 8 strips.  The widest slice of 64, 32, 16 (at most
    ``dv`` rounded up to 16) that fits, at tile 32, or at tile 64 first
    when dk > 64 (``chip_smoke.py``'s sweep on an H100: dk=dv=64 runs
    fastest at 32 / 64, dk=128 at 64 / 64), then tile 16.  Raises for
    what the kernel refuses."""
    if b < 1 or h < 1:
        raise ValueError(f"empty launch: B={b} H={h}")
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"dk={dk} and dv={dv} must be in [1, {MAX_DIM}]")
    dvp = _round16(dv)
    for tile in ((64, 32, 16) if dk > 64 else (32, 16)):
        for dvs in (64, 32, 16):
            strips = dvs // 16 * -(-_round16(dk) // 64)
            if dvs > dvp or strips > _WARPS:
                continue
            smem = scan_smem(tile, dvs, dk, elem_bytes)
            if smem <= MAX_SMEM:
                return tile, dvs, smem
    raise ValueError(f"dk={dk} dv={dv}: no tile fits {MAX_SMEM} B")


def _check(q, k, v, logw, chunk, state0):
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 \
            or v.shape[:3] != q.shape[:3] or logw.shape != q.shape[:3]:
        raise ValueError(
            f"expected q/k (B, T, H, dk), v (B, T, H, dv), logw (B, T, H); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(logw.shape)}")
    b, _, h, dk = q.shape
    dv = v.shape[-1]
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1; got {chunk}")
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


class _SSDScan(torch.autograd.Function):
    """``ssd_scan`` with a gradient: the forward of :func:`_scan`, the
    backward through a recompute of :func:`ssd_scan_plain`."""

    @staticmethod
    def forward(ctx, q, k, v, logw, state0, chunk, return_state):
        ctx.chunk, ctx.return_state = chunk, return_state
        ctx.save_for_backward(q, k, v, logw, state0)
        return _scan(q, k, v, logw, chunk, state0, return_state)

    @staticmethod
    def backward(ctx, *grad_outputs):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            outs = ssd_scan_plain(*inputs[:4], chunk=ctx.chunk,
                                  state0=inputs[4],
                                  return_state=ctx.return_state)
            outs = outs if ctx.return_state else (outs,)
            wrt = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(outs, wrt, grad_outputs,
                                             allow_unused=True))
        return tuple(next(grads) if n else None for n in need) \
            + (None, None)


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, *, chunk: int = 128,
             state0: torch.Tensor | None = None,
             return_state: bool = False):
    """q/k: (B, T, H, dk), v: (B, T, H, dv) (float32 or bfloat16, one
    dtype), logw: (B, T, H) float32 (<= 0), state0: (B, H, dk, dv)
    float32 or None (zeros).  Returns out (B, T, H, dv) in q's dtype, and
    with ``return_state`` also the final state (B, H, dk, dv) float32.
    Differentiable (see the module's docstring)."""
    _check(q, k, v, logw, chunk, state0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, logw, state0)):
        return _SSDScan.apply(q, k, v, logw, state0, chunk, return_state)
    return _scan(q, k, v, logw, chunk, state0, return_state)


def _scan(q, k, v, logw, chunk, state0, return_state):
    """The launch (CUDA) or the plain version (CPU), outside autograd."""
    global launches
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
        tile, dvs, _ = scan_launch(b, h, dk, dv, q.element_size())
        strides = (ctypes.c_longlong * 12)(
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *logw.stride())
        fn = build.function("ssd_scan", "ssd_scan", _ARGTYPES)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                None if state0 is None else state0.data_ptr(),
                out.data_ptr(), None if final is None else final.data_ptr(),
                b, t, h, dk, dv, tile, dvs, ctypes.addressof(strides),
                int(q.dtype == torch.bfloat16), build.stream_handle(q.device))
        build.check_launch("ssd_scan", rc)
        launches += 1
    elif final is not None and state0 is not None:
        final.copy_(state0)
    elif final is not None:
        final.zero_()
    return (out, final) if return_state else out
