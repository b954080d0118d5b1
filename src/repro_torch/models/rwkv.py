"""RWKV-6 ("Finch") time-mix and channel-mix blocks (arXiv:2404.05892).

Port of ``src/repro/models/rwkv.py``: :func:`init_rwkv_time_mix`,
:func:`_token_shift`, :func:`_decay_log`, :func:`apply_rwkv_time_mix`,
:func:`apply_rwkv_time_mix_step`, :func:`init_rwkv_channel_mix`,
:func:`apply_rwkv_channel_mix` and :func:`apply_rwkv_channel_mix_step`.
Attention-free: the time mix is linear attention with a data-dependent
per-channel decay ``w_t = exp(-exp(w0 + tanh(x A) B))`` and a bonus ``u``
for the current token, after a token-shift interpolation; the output is
gated.  The recurrence runs through the plain
``linear_attention.recurrent_scan`` (prefill) and ``recurrent_step``
(decode) in rwkv mode, as in the reference: ``kernels.linear_scan.ssd_scan``
takes a scalar decay per head, and this decay is per channel.
``decay_w0``, ``bonus_u`` and ``mix`` are f32, as in the reference.

Decode state per layer: the time mix's shift (B, d) and state (B, H, hd,
hd) f32, and the channel mix's shift (B, d).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init
from .linear_attention import recurrent_scan, recurrent_step


def init_rwkv_time_mix(gen: torch.Generator, cfg, *, lead: tuple = (),
                       device=None) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    r = cfg.rwkv.decay_lora
    dtype = getattr(torch, cfg.dtype)

    def dense(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, dtype, lead=lead, scale=scale,
                          device=device)

    def const(shape, fill):
        return torch.full(lead + shape, fill, dtype=torch.float32,
                          device=device)

    return {
        "w_r": dense(d, d), "w_k": dense(d, d), "w_v": dense(d, d),
        "w_g": dense(d, d), "w_o": dense(d, d, scale=d ** -0.5),
        # the data-dependent decay's LoRA: w = w0 + tanh(x A) B
        "decay_a": dense(d, r),
        "decay_b": dense(r, d, scale=r ** -0.5),
        "decay_w0": const((d,), -2.0),
        "bonus_u": const((d // hd, hd), 0.0),
        # token-shift mixing coefficients of r, k, v, g, w
        "mix": const((5, d), 0.5),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None
                 ) -> torch.Tensor:
    """The x_{t-1} stream: x shifted right by one token; position 0 sees
    ``prev`` (zeros when None)."""
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        shifted = shifted.clone()
        shifted[:, 0] = prev
    return shifted


def _decay_log(p: dict, xm: torch.Tensor) -> torch.Tensor:
    """log w_t = -exp(w0 + tanh(x A) B), f32, in (-inf, 0)."""
    lora = torch.tanh(xm @ p["decay_a"]) @ p["decay_b"]
    return -torch.exp(p["decay_w0"] + lora.to(torch.float32))


def _mixed(p: dict, x: torch.Tensor, shifted: torch.Tensor, n: int):
    return [x + p["mix"][i].to(x.dtype) * (shifted - x) for i in range(n)]


def apply_rwkv_time_mix(cfg, p: dict, x: torch.Tensor,
                        prev_shift: torch.Tensor | None = None,
                        state0: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, T, d).  Returns (out (B, T, d) in x's dtype, final state
    (B, H, hd, hd) f32, last x (B, d)) for streaming."""
    b, t, d = x.shape
    hd = cfg.rwkv.head_dim
    h = d // hd
    rm, km, vm, gm, wm = _mixed(p, x, _token_shift(x, prev_shift), 5)
    rr = (rm @ p["w_r"]).reshape(b, t, h, hd)
    kk = (km @ p["w_k"]).reshape(b, t, h, hd)
    vv = (vm @ p["w_v"]).reshape(b, t, h, hd)
    gg = F.silu(gm @ p["w_g"])
    logw = _decay_log(p, wm).reshape(b, t, h, hd)
    out, state = recurrent_scan(rr, kk, vv, logw, u=p["bonus_u"],
                                state0=state0, rwkv_mode=True)
    y = (out.reshape(b, t, d) * gg) @ p["w_o"]
    return y, state, x[:, -1]


def apply_rwkv_time_mix_step(cfg, p: dict, x: torch.Tensor,
                             shift_prev: torch.Tensor, state: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Decode step.  x, shift_prev: (B, d); state: (B, H, hd, hd).
    Returns (out (B, d) f32, new state, x as the next shift)."""
    b, d = x.shape
    hd = cfg.rwkv.head_dim
    h = d // hd
    rm, km, vm, gm, wm = _mixed(p, x, shift_prev, 5)
    rr = (rm @ p["w_r"]).reshape(b, h, hd)
    kk = (km @ p["w_k"]).reshape(b, h, hd)
    vv = (vm @ p["w_v"]).reshape(b, h, hd)
    gg = F.silu(gm @ p["w_g"])
    logw = _decay_log(p, wm).reshape(b, h, hd)
    out, state = recurrent_step(rr, kk, vv, logw, state, u=p["bonus_u"],
                                rwkv_mode=True)
    # the step's output is f32, and so is this product, as the reference
    # promotes it (f32 activations times the model-dtype weights)
    a = out.reshape(b, d) * gg
    return a @ p["w_o"].to(a.dtype), state, x


def init_rwkv_channel_mix(gen: torch.Generator, cfg, *, lead: tuple = (),
                          device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dtype = getattr(torch, cfg.dtype)
    return {
        "w_k": dense_init(gen, d, f, dtype, lead=lead, device=device),
        "w_v": dense_init(gen, f, d, dtype, lead=lead, scale=f ** -0.5,
                          device=device),
        "mix": torch.full(lead + (1, d), 0.5, dtype=torch.float32,
                          device=device),
    }


def apply_rwkv_channel_mix(cfg, p: dict, x: torch.Tensor,
                           prev_shift: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d).  Returns (out (B, T, d), last x (B, d))."""
    (km,) = _mixed(p, x, _token_shift(x, prev_shift), 1)
    hh = torch.square(F.relu(km @ p["w_k"]))
    return hh @ p["w_v"], x[:, -1]


def apply_rwkv_channel_mix_step(cfg, p: dict, x: torch.Tensor,
                                shift_prev: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode step.  x, shift_prev: (B, d).  Returns (out, x)."""
    (km,) = _mixed(p, x, shift_prev, 1)
    hh = torch.square(F.relu(km @ p["w_k"]))
    return hh @ p["w_v"], x
