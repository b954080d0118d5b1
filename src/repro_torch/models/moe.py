"""Mixture-of-Experts FFN with capacity-based scatter dispatch.

Port of ``src/repro/models/moe.py``: :func:`init_moe`,
:func:`moe_capacity`, :func:`apply_moe` and the dense oracle
:func:`apply_moe_reference`.  Top-k routing in f32 -> cumulative-sum slot
assignment per group (= per batch row) -> scatter into per-expert buffers
(B, E, C+1, d), the last slot catching the tokens over capacity -> batched
expert products -> gather and combine.  Arctic's dense residual MLP runs
beside the experts where ``dense_residual_ff`` is set.

The reference computes all of this outside any Pallas kernel, so the
port's expert products stay ``torch.einsum``.  Two details keep the
discrete decisions the reference's: the top-k comes from a stable
descending sort, so that tied probabilities go to the lower expert index
as in ``lax.top_k``, and a kept token's (expert, slot) is unique, so the
scatter-add writes each kept row once, exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import activation, apply_mlp, dense_init, init_mlp
from .shard_utils import dp_spec, local_rows, maybe_shard, rows_like, unshard


def init_moe(gen: torch.Generator, cfg, *, lead: tuple = (),
             device=None) -> dict:
    """Router (d, E) f32, experts ``w_gate`` / ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d) in the model dtype (truncated normals scaled like
    the reference's), and Arctic's ``dense`` MLP; each leaf with the
    leading shape ``lead``.  Drawn from ``gen`` in that order."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_expert, moe.n_experts
    dtype = getattr(torch, cfg.dtype)

    def experts(shape, scale):
        t = torch.empty(lead + shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * scale).to(dtype)

    p = {"router": dense_init(gen, d, e, torch.float32, lead=lead,
                              device=device),
         "w_gate": experts((e, d, f), d ** -0.5),
         "w_up": experts((e, d, f), d ** -0.5),
         "w_down": experts((e, f, d), f ** -0.5)}
    if moe.dense_residual_ff:
        p["dense"] = init_mlp(gen, cfg, d_ff=moe.dense_residual_ff,
                              lead=lead, device=device)
    return p


def moe_capacity(tokens_per_group: int, cfg) -> int:
    moe = cfg.moe
    c = int(tokens_per_group * moe.top_k * moe.capacity_factor
            / moe.n_experts)
    return max(moe.top_k, min(tokens_per_group, c))


def route(cfg, x2: torch.Tensor, router: torch.Tensor):
    """f32 router probabilities of ``x2`` (..., d), and the top-k gates
    (renormalized) and expert ids, ties to the lower expert."""
    probs = torch.softmax(x2.to(torch.float32) @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, choice = vals[..., :cfg.moe.top_k], idx[..., :cfg.moe.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, choice


def dispatch(cfg, choice: torch.Tensor, s: int):
    """Per group: each (token, choice)'s slot in its expert's buffer.
    ``choice`` (B, S, k).  Returns the expert ids and slots (B, S*k), the
    slot capped to the overflow slot ``cap``, and ``keep`` (slot < cap)."""
    b, k = choice.shape[0], choice.shape[-1]
    cap = moe_capacity(s, cfg)
    flat = F.one_hot(choice, cfg.moe.n_experts).reshape(b, s * k, -1)
    slot = ((torch.cumsum(flat, dim=1) - 1) * flat).sum(-1)   # (B, S*k)
    keep = slot < cap
    slot_c = torch.where(keep, slot, torch.full_like(slot, cap))
    return choice.reshape(b, s * k), slot_c, keep, cap


def apply_moe(cfg, p: dict, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  Returns (y in x's dtype, aux loss f32 scalar)."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    probs, gates, choice = route(cfg, x, p["router"])
    # load-balancing auxiliary loss (Switch-style), over all tokens
    density = F.one_hot(choice[..., 0], e).to(torch.float32).mean(dim=(0, 1))
    aux = (density * probs.mean(dim=(0, 1))).sum() * e

    e_flat, slot_c, keep, cap = dispatch(cfg, choice, s)
    xin = x[:, :, None].expand(b, s, k, d).reshape(b, s * k, d)
    xin = (xin * keep[..., None]).to(x.dtype)
    xin = maybe_shard(xin, dp_spec(), None, None)
    # each group (batch row) fills its own expert buffers, so under a
    # mesh every rank dispatches and combines its own rows of the
    # DP-sharded batch with no collective: DTensor has no rule for an
    # integer-indexed scatter-add or gather, so ``local_rows`` hands the
    # rank's rows over as plain tensors and ``rows_like`` places the
    # result as ``xin`` is placed (both the identity without a mesh)
    e_loc = local_rows(maybe_shard(e_flat, dp_spec(), None))
    s_loc = local_rows(maybe_shard(slot_c, dp_spec(), None))
    x_loc = local_rows(xin)
    bl = x_loc.shape[0]
    rows = torch.arange(bl, device=x_loc.device)[:, None].expand(bl, s * k)
    buf = torch.zeros((bl, e, cap + 1, d), dtype=x.dtype,
                      device=x_loc.device)
    buf.index_put_((rows, e_loc, s_loc), x_loc, accumulate=True)
    buf = rows_like(buf[:, :, :cap], xin)                     # (B, E, C, d)
    buf = maybe_shard(buf, dp_spec(), "model", None, None)
    # FSDP gathers an expert matrix's 'data'-sharded dim before its
    # product (explicit: DTensor's einsum fails on a product whose
    # output dim is sharded); the expert dim stays on 'model'
    w_gate, w_up, w_down = (unshard(p[n], -2, -1)
                            for n in ("w_gate", "w_up", "w_down"))
    g = torch.einsum("becd,edf->becf", buf, w_gate)
    u = torch.einsum("becd,edf->becf", buf, w_up)
    h = activation(cfg.act, g) * u
    h = maybe_shard(h, dp_spec(), "model", None, None)
    out_buf = F.pad(torch.einsum("becf,efd->becd", h, w_down),
                    (0, 0, 0, 1))                             # (B, E, C+1, d)
    # explicit gather: a row's combine reads every expert, so the expert
    # outputs are gathered over 'model' (the rows stay on their ranks)
    out_buf = unshard(maybe_shard(out_buf, dp_spec(), "model", None, None),
                      1)
    y_flat = rows_like(local_rows(out_buf)[rows, e_loc, s_loc],
                       xin)                                   # (B, S*k, d)
    w = (gates.reshape(b, s * k) * keep).to(x.dtype)
    y = (y_flat * w[..., None]).reshape(b, s, k, d).sum(dim=2)
    if moe.dense_residual_ff:
        y = y + apply_mlp(cfg, p["dense"], x)
    return y, aux


def apply_moe_reference(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense oracle: every token through its top-k experts exactly (no
    capacity drops).  Computes every expert for every token: tests
    only."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    _, gates, choice = route(cfg, xt, p["router"])
    g = torch.einsum("td,edf->etf", xt, p["w_gate"])
    u = torch.einsum("td,edf->etf", xt, p["w_up"])
    h = activation(cfg.act, g) * u
    full = torch.einsum("etf,efd->etd", h, p["w_down"])      # (E, T, d)
    sel = torch.gather(full.transpose(0, 1), 1,
                       choice[..., None].expand(-1, -1, d))   # (T, k, d)
    y = (sel * gates[..., None].to(sel.dtype)).sum(dim=1)
    y = y.reshape(b, s, d).to(x.dtype)
    if cfg.moe.dense_residual_ff:
        y = y + apply_mlp(cfg, p["dense"], x)
    return y
