"""Recurrent linear attention — the sequential oracle for Mamba (SSD).

Port of ``src/repro/models/linear_attention.py``: :func:`recurrent_scan`
(with its T padding, ``:42-48``, and both modes) and
:func:`recurrent_step` (``:93-110``), in plain PyTorch.  State-space
recurrence with per-token decay:

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t          (B, H, dk, dv) state
    out_t = q_t . S_t                              (mamba/SSD form)
    out_t = q_t . (S_{t-1} + diag(u) k_t (x) v_t)  (rwkv form, bonus u)

The reference runs it as ``lax.scan`` over mini-chunks; here it is a
Python loop over tokens, one step at a time (the chunking only sets the
padding, which changes no result).  The Mamba prefill does not run it:
``kernels.linear_scan.ssd_scan`` computes the same function for a scalar
decay per head; this loop is what the tests hold it against.
"""
from __future__ import annotations

import torch

from .shard_utils import dp_spec, maybe_shard


def _step(s, qt, kt, vt, wt, u, rwkv_mode: bool):
    kv = kt[..., :, None] * vt[..., None, :]                  # (B,H,dk,dv)
    if rwkv_mode:
        eff = s + (u.to(torch.float32)[None, :, :, None] * kv
                   if u is not None else kv)
        out = torch.einsum("bhk,bhkv->bhv", qt, eff)
        s = wt[..., None] * s + kv
    else:
        s = wt[..., None] * s + kv
        out = torch.einsum("bhk,bhkv->bhv", qt, s)
    return out, s


def recurrent_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_decay: torch.Tensor, u: torch.Tensor | None = None,
                   state0: torch.Tensor | None = None, *, chunk: int = 32,
                   rwkv_mode: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """q/k: (B,T,H,dk), v: (B,T,H,dv), log_decay: (B,T,H,dk) or
    (B,T,H,1) (<= 0; a trailing 1 is a scalar decay per head, broadcast
    in the step).  u: (H, dk) rwkv bonus (rwkv_mode only).
    Returns (out (B,T,H,dv) in q's dtype, final_state (B,H,dk,dv) f32)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    if t % chunk:
        # zero q/k/v and log-decay 0 (decay 1) leave the state unchanged
        pad = chunk - t % chunk
        q, k, v, log_decay = (
            torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
            for a in (q, k, v, log_decay))
    w = torch.exp(log_decay.to(torch.float32))
    s = state0 if state0 is not None else torch.zeros(
        (b, h, dk, dv), dtype=torch.float32, device=q.device)
    s = s.to(torch.float32)
    outs = []
    for i in range(q.shape[1]):
        out, s = _step(s, q[:, i].to(torch.float32),
                       k[:, i].to(torch.float32), v[:, i].to(torch.float32),
                       w[:, i], u, rwkv_mode)
        # keep the carried state head-sharded (the reference constrains
        # it once per mini-chunk; here once per token, same placement)
        s = maybe_shard(s, dp_spec(), "model", None, None)
        outs.append(out)
    out = torch.stack(outs, dim=1)[:, :t]
    return out.to(q.dtype), s


def recurrent_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_decay: torch.Tensor, state: torch.Tensor,
                   u: torch.Tensor | None = None, *, rwkv_mode: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode step.  q/k/log_decay: (B,H,dk) (or (B,H,1)),
    v: (B,H,dv); state: (B,H,dk,dv).  Returns (out (B,H,dv) f32,
    new_state)."""
    w = torch.exp(log_decay.to(torch.float32))
    return _step(state, q.to(torch.float32), k.to(torch.float32),
                 v.to(torch.float32), w, u, rwkv_mode)
