"""Mamba block in SSD (Mamba-2 state-space-duality) form — for jamba.

Port of ``src/repro/models/mamba.py``: :func:`init_mamba`,
:func:`_ssm_inputs` (``:41-61``), :func:`apply_mamba` (``:63-76``) and
:func:`apply_mamba_step` (``:79-91``).  Per-head scalar decay
``a_t = exp(-softplus(dt) * exp(a_log))`` with data-dependent dt; the B_t
/ C_t projections play k / q.  The prefill scan runs through
``kernels.linear_scan.ssd_scan`` (the CUDA kernel on the card), which
computes what the reference's ``recurrent_scan`` computes for this decay;
the decode step runs ``linear_attention.recurrent_step``.  Placed on a
mesh, the prefill scan runs on each rank's own rows of the batch, as
plain tensors (:func:`apply_mamba`), so the kernel stays on the path.

Decode state per layer: S (B, H, d_state, head_dim) f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.linear_scan import ssd_scan, ssd_scan_plain
from .layers import dense_init
from .linear_attention import recurrent_step
from .shard_utils import dp_spec, local_rows, maybe_shard, rows_like


def _dims(cfg) -> tuple[int, int, int]:
    """(d_inner, SSM heads, d_state)."""
    di = cfg.ssm.expand * cfg.d_model
    return di, di // cfg.ssm.head_dim, cfg.ssm.d_state


def init_mamba(gen: torch.Generator, cfg, *, lead: tuple = (),
               device=None) -> dict:
    d = cfg.d_model
    di, h, n = _dims(cfg)
    dtype = getattr(torch, cfg.dtype)

    def dense(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, dtype, lead=lead, scale=scale,
                          device=device)

    def vec(fill):
        return torch.full(lead + (h,), fill, dtype=torch.float32,
                          device=device)

    return {
        "w_in": dense(d, 2 * di),              # x and gate z
        "w_bc": dense(d, 2 * h * n),           # B_t, C_t per head
        "w_dt": dense(d, h),
        "dt_bias": vec(0.0),
        "a_log": vec(0.0),                     # A = -exp(a_log)
        "d_skip": vec(1.0),
        "w_out": dense(di, d, scale=di ** -0.5),
    }


def _ssm_inputs(cfg, p: dict, x: torch.Tensor):
    """Common projections.  x: (B, T, d) -> (xh, z, Bk, Cq, v, log_a).

    dt is f32 (``softplus(f32(x @ w_dt) + dt_bias)``), ``log_a = -dt *
    exp(a_log)`` f32, and ``v = xh * dt`` in the model dtype, as in the
    reference.  Bk / Cq are views into one matmul output."""
    b, t, _ = x.shape
    di, h, n = _dims(cfg)
    xh, z = torch.split(x @ p["w_in"], di, dim=-1)           # (B, T, di)
    bk, cq = torch.split(x @ p["w_bc"], h * n, dim=-1)
    bk = bk.reshape(b, t, h, n)
    cq = cq.reshape(b, t, h, n)
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp((x @ p["w_dt"]).to(torch.float32) + p["dt_bias"],
                         torch.zeros((), device=x.device))    # (B, T, H)
    log_a = -dt * torch.exp(p["a_log"])                       # <= 0
    xh = xh.reshape(b, t, h, cfg.ssm.head_dim)
    v = xh * dt[..., None].to(xh.dtype)                       # ZOH-style
    return xh, z, bk, cq, v, log_a


def apply_mamba(cfg, p: dict, x: torch.Tensor,
                state0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d).  Returns (out (B, T, d), final_state)."""
    b, t, _ = x.shape
    di = cfg.ssm.expand * cfg.d_model
    xh, z, bk, cq, v, log_a = _ssm_inputs(cfg, p, x)
    # meta tensors (the dry run's counted runs) take the kernel's plain
    # version: the kernel's wrapper runs on cpu or cuda only
    scan = ssd_scan_plain if cq.is_meta else ssd_scan
    # placed: the scan needs each row's whole sequence and every head,
    # and the kernel takes plain tensors, so every dim but the batch is
    # gathered (explicit) and each rank scans its own rows of the
    # DP-sharded batch with no collective (rows are independent);
    # ``rows_like`` places the results as the gathered v is placed.  The
    # identity without a mesh; gradients go back through the same calls
    cq, bk, v, log_a = (maybe_shard(a, dp_spec(), *(None,) * (a.ndim - 1))
                        for a in (cq, bk, v, log_a))
    if state0 is not None:
        state0 = local_rows(maybe_shard(state0, dp_spec(), None, None, None))
    out, state = scan(local_rows(cq), local_rows(bk), local_rows(v),
                      local_rows(log_a), state0=state0,
                      return_state=True)                      # (B,T,H,hd)
    out, state = rows_like(out, v), rows_like(state, v)
    out = out + xh * p["d_skip"][None, None, :, None].to(xh.dtype)
    y = (out.reshape(b, t, di) * F.silu(z)) @ p["w_out"]
    return y, state


def apply_mamba_step(cfg, p: dict, x: torch.Tensor, state: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode step.  x: (B, d); state: (B, H, d_state, head_dim).
    Returns (out (B, d), new_state)."""
    b = x.shape[0]
    di = cfg.ssm.expand * cfg.d_model
    xh, z, bk, cq, v, log_a = _ssm_inputs(cfg, p, x[:, None])
    out, state = recurrent_step(cq[:, 0], bk[:, 0], v[:, 0],
                                log_a[:, 0, :, None], state)
    out = out + xh[:, 0] * p["d_skip"][None, :, None].to(xh.dtype)
    # the scan output is f32 here, and so is this product, as the
    # reference promotes it (f32 activations times the model-dtype weights)
    a = out.reshape(b, di) * F.silu(z[:, 0])
    y = a @ p["w_out"].to(a.dtype)
    return y, state
