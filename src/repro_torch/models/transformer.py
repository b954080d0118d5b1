"""Layer stack for every model family.

Port of ``src/repro/models/transformer.py``: :class:`SubLayerSpec`,
:func:`period_template` (``:42-52``), :func:`n_periods`,
:func:`init_stack` (``:88-100``), :func:`_sublayer_forward`
(``:105-149``) and :func:`forward_stack` (``:152-195``).  A period is the
smallest repeating sublayer template:

* dense / MoE / VLM: one ``[attn -> mlp|moe]`` sublayer;
* ssm (RWKV-6): one ``[time mix -> channel mix]`` sublayer;
* hybrid (jamba): ``attn_every`` sublayers, the last one attention and
  the rest Mamba, their FFNs MoE where ``cfg.layer_is_moe``;
* encdec (whisper): the decoder's sublayer carries a cross-attention
  over the encoder's memory; the encoder is a dense stack of its own.

Every parameter leaf is stacked over periods, as in the reference;
where the reference scans over periods, this is a Python loop.  Under a
mesh, each period's carry is sequence-parallel at both of its ends
(``maybe_shard(x, dp_spec(), "model", None)``, ``:171`` and ``:182``),
and a MoE sublayer leaves that regime before its dispatch; without a
mesh both are the identity.

Remat (``forward_stack(..., remat=)``, ``:185-192``) wraps each period
when a backward will run through it (grad enabled and an input that
requires grad): ``"full"`` keeps only the period's input and recomputes
the rest in the backward (``torch.utils.checkpoint``, non-reentrant);
``"dots"``, the reference's ``dots_with_no_batch_dims_saveable``, saves
the outputs of the weight products (``aten.mm`` / ``aten.addmm``) and
recomputes everything else, batched products (``bmm``, attention's
einsums) included; ``"none"`` saves everything.  Without a backward
(serving, prefill) nothing is wrapped, so those paths run as before.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..pytree import flatten
from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm, rope_freqs
from .shard_utils import dp_spec, maybe_shard, split_heads


@dataclasses.dataclass(frozen=True)
class SubLayerSpec:
    mixer: str                   # "attn" | "mamba" | "rwkv"
    ffn: str                     # "mlp" | "moe" | "rwkv_channel"
    cross: bool = False          # whisper decoder cross-attention


def period_template(cfg) -> tuple[SubLayerSpec, ...]:
    if cfg.family == "ssm":
        return tuple(SubLayerSpec("rwkv", "rwkv_channel")
                     for _ in range(max(1, cfg.attn_every)))
    return tuple(SubLayerSpec("attn" if cfg.layer_is_attn(s) else "mamba",
                              "moe" if cfg.layer_is_moe(s) else "mlp",
                              cross=cfg.family == "encdec")
                 for s in range(max(1, cfg.attn_every)))


def encoder_config(cfg):
    """The encoder stack's config: a dense stack of the encoder's depth
    (``src/repro/models/model.py:64-66``)."""
    return dataclasses.replace(cfg, family="dense",
                               n_layers=cfg.encoder.n_layers, attn_every=1,
                               moe=None)


def n_periods(cfg) -> int:
    p = max(1, cfg.attn_every)
    if cfg.n_layers % p:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"period {p}")
    return cfg.n_layers // p


def init_stack(gen: torch.Generator, cfg, *, device=None) -> list[dict]:
    """Per-sublayer parameter trees, each leaf stacked over n_periods.
    Draws the mixer's weights, the cross-attention's, then the FFN's,
    sublayer after sublayer."""
    lead = (n_periods(cfg),)
    kw = dict(lead=lead, device=device)
    out = []
    for spec in period_template(cfg):
        p = {"norm1": init_norm(cfg, cfg.d_model, **kw),
             "norm2": init_norm(cfg, cfg.d_model, **kw)}
        if spec.mixer == "attn":
            p["attn"] = attn.init_attention(gen, cfg, **kw)
        elif spec.mixer == "mamba":
            p["mamba"] = mam.init_mamba(gen, cfg, **kw)
        else:
            p["rwkv_t"] = rwkv_mod.init_rwkv_time_mix(gen, cfg, **kw)
        if spec.cross:
            p["cross"] = attn.init_attention(gen, cfg, **kw)
            p["norm_cross"] = init_norm(cfg, cfg.d_model, **kw)
        if spec.ffn == "moe":
            p["moe"] = moe_mod.init_moe(gen, cfg, **kw)
        elif spec.ffn == "mlp":
            p["mlp"] = init_mlp(gen, cfg, **kw)
        else:
            p["rwkv_c"] = rwkv_mod.init_rwkv_channel_mix(gen, cfg, **kw)
        out.append(p)
    return out


def period_params(tree, i: int):
    """Period ``i``'s slice of a stacked parameter (sub)tree."""
    if isinstance(tree, dict):
        return {k: period_params(v, i) for k, v in tree.items()}
    return tree[i]


def _sublayer_forward(cfg, spec: SubLayerSpec, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, inv_freq,
                      cross_memory: torch.Tensor | None = None,
                      causal: bool = True, collect_cache: bool = False):
    """Returns (x, aux loss f32 scalar, cache_kv or None).  The Mamba and
    RWKV final states are discarded, as in the reference (``:125-128``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    h = apply_norm(cfg, p["norm1"], x)
    if spec.mixer == "attn":
        b, s, _ = h.shape
        if collect_cache:
            k = split_heads(attn._project(cfg, p["attn"], h, "k"),
                            b, s, cfg.n_kv_heads, cfg.head_dim)
            v = split_heads(attn._project(cfg, p["attn"], h, "v"),
                            b, s, cfg.n_kv_heads, cfg.head_dim)
            k = attn.apply_rope(k, positions, inv_freq, cfg.mrope_sections)
            cache = (k, v)
        x = x + attn.attention_block(cfg, p["attn"], h, positions, inv_freq,
                                     causal=causal)
    elif spec.mixer == "mamba":
        y, _ = mam.apply_mamba(cfg, p["mamba"], h)
        x = x + y
    else:
        y, _, _ = rwkv_mod.apply_rwkv_time_mix(cfg, p["rwkv_t"], h)
        x = x + y
    if spec.cross and cross_memory is not None:
        hc = apply_norm(cfg, p["norm_cross"], x)
        x = x + attn.cross_attention_block(cfg, p["cross"], hc,
                                           memory=cross_memory)
    h2 = apply_norm(cfg, p["norm2"], x)
    if spec.ffn == "moe":
        # leave the sequence-parallel regime once, before the dispatch
        # (``:137-143``): the capacity slots count tokens along the
        # sequence, so MoE routes and dispatches a replicated sequence
        h2 = maybe_shard(h2, dp_spec(), None, None)
        y, aux = moe_mod.apply_moe(cfg, p["moe"], h2)
        x = x + y
    elif spec.ffn == "mlp":
        x = x + apply_mlp(cfg, p["mlp"], h2)
    else:
        y, _ = rwkv_mod.apply_rwkv_channel_mix(cfg, p["rwkv_c"], h2)
        x = x + y
    return x, aux, cache


REMAT_POLICIES = ("full", "dots", "none")

#: the weight products "dots" saves: 2-D matmuls (a (B, S, d) activation
#: times a weight folds to one); batched products are recomputed
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _needs_grad(x: torch.Tensor, blocks, cross_memory) -> bool:
    if not torch.is_grad_enabled():
        return False
    tensors = [x] + flatten(blocks)
    if cross_memory is not None:
        tensors.append(cross_memory)
    return any(t.requires_grad for t in tensors)


def forward_stack(cfg, blocks: list[dict], x: torch.Tensor,
                  positions: torch.Tensor, *,
                  cross_memory: torch.Tensor | None = None,
                  causal: bool = True, collect_cache: bool = False,
                  remat: str = "full"):
    """Run the period stack.  Returns (x, total aux loss, caches or
    None): per attention sublayer, (k, v) stacked over periods
    (n_periods, B, S, Hkv, hd).  ``cross_memory`` (B, ctx, d) is the
    encoder's output that the decoder's cross-attention reads;
    ``causal=False`` is the encoder's self-attention; ``remat`` one of
    :data:`REMAT_POLICIES` (see the module's docstring)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")
    template = period_template(cfg)
    inv_freq = rope_freqs(cfg, x.device)

    def period(i, x):
        # Megatron-style sequence-parallel boundary (``:165-171``, and
        # ``:182`` at the period's end): the carry, the one activation a
        # period saves under remat, lives with S sharded over 'model' at
        # both ends of the period, so the saved residuals shrink by the
        # TP degree.  The identity without a mesh (the same object back)
        x = maybe_shard(x, dp_spec(), "model", None)
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for si, spec in enumerate(template):
            x, aux, cache = _sublayer_forward(
                cfg, spec, period_params(blocks[si], i), x, positions,
                inv_freq, cross_memory=cross_memory, causal=causal,
                collect_cache=collect_cache and spec.mixer == "attn")
            aux_sum = aux_sum + aux
            if cache is not None:
                caches.append(cache)
        x = maybe_shard(x, dp_spec(), "model", None)
        return x, aux_sum, caches

    if remat != "none" and _needs_grad(x, blocks, cross_memory):
        kw = {} if remat == "full" else {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}
        run = functools.partial(checkpoint, period, use_reentrant=False,
                                **kw)
    else:
        run = period
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    per_period = []
    for i in range(n_periods(cfg)):
        x, aux, caches = run(i, x)
        total = total + aux
        per_period.append(caches)
    if not collect_cache:
        return x, total, None
    stacked = tuple(
        (torch.stack([pc[j][0] for pc in per_period]),
         torch.stack([pc[j][1] for pc in per_period]))
        for j in range(len(per_period[0])))
    return x, total, stacked
