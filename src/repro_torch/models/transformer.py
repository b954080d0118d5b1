"""Layer stack for the dense, MoE and hybrid families.

Port of ``src/repro/models/transformer.py``: :class:`SubLayerSpec`,
:func:`period_template` (``:42-52``), :func:`n_periods`,
:func:`init_stack` (``:88-100``), :func:`_sublayer_forward`
(``:105-149``) and :func:`forward_stack` (``:152-195``).  A period is the
smallest repeating sublayer template: one ``[attn -> mlp|moe]`` sublayer
for the dense and MoE families; ``attn_every`` sublayers for the hybrid
(jamba), the last one attention and the rest Mamba, their FFNs MoE where
``cfg.layer_is_moe``.  Every parameter leaf is stacked over periods, as
in the reference; where the reference scans over periods, this is a
Python loop.  There is no remat (a training concern, ROADMAP A14).

Not yet ported, and refused with ``NotImplementedError``: the RWKV
(``ssm``), encoder-decoder and VLM families (ROADMAP A13c-e).
"""
from __future__ import annotations

import dataclasses

import torch

from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm, rope_freqs


@dataclasses.dataclass(frozen=True)
class SubLayerSpec:
    mixer: str                   # "attn" | "mamba"
    ffn: str                     # "mlp" | "moe"


def check_supported(cfg) -> None:
    """Raise for the families of A13 that later PRs port."""
    if cfg.family not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP A13)")


def period_template(cfg) -> tuple[SubLayerSpec, ...]:
    check_supported(cfg)
    return tuple(SubLayerSpec("attn" if cfg.layer_is_attn(s) else "mamba",
                              "moe" if cfg.layer_is_moe(s) else "mlp")
                 for s in range(max(1, cfg.attn_every)))


def n_periods(cfg) -> int:
    p = max(1, cfg.attn_every)
    if cfg.n_layers % p:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"period {p}")
    return cfg.n_layers // p


def init_stack(gen: torch.Generator, cfg, *, device=None) -> list[dict]:
    """Per-sublayer parameter trees, each leaf stacked over n_periods.
    Draws the mixer's weights, then the FFN's, sublayer after sublayer."""
    lead = (n_periods(cfg),)
    out = []
    for spec in period_template(cfg):
        p = {"norm1": init_norm(cfg, cfg.d_model, lead=lead, device=device),
             "norm2": init_norm(cfg, cfg.d_model, lead=lead, device=device)}
        if spec.mixer == "attn":
            p["attn"] = attn.init_attention(gen, cfg, lead=lead,
                                            device=device)
        else:
            p["mamba"] = mam.init_mamba(gen, cfg, lead=lead, device=device)
        if spec.ffn == "moe":
            p["moe"] = moe_mod.init_moe(gen, cfg, lead=lead, device=device)
        else:
            p["mlp"] = init_mlp(gen, cfg, lead=lead, device=device)
        out.append(p)
    return out


def period_params(tree, i: int):
    """Period ``i``'s slice of a stacked parameter (sub)tree."""
    if isinstance(tree, dict):
        return {k: period_params(v, i) for k, v in tree.items()}
    return tree[i]


def _sublayer_forward(cfg, spec: SubLayerSpec, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, inv_freq,
                      collect_cache: bool = False):
    """Returns (x, aux loss f32 scalar, cache_kv or None).  The Mamba
    final state is discarded, as in the reference (``:125``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    h = apply_norm(cfg, p["norm1"], x)
    if spec.mixer == "attn":
        b, s, _ = h.shape
        if collect_cache:
            k = attn._project(cfg, p["attn"], h, "k").reshape(
                b, s, cfg.n_kv_heads, cfg.head_dim)
            v = attn._project(cfg, p["attn"], h, "v").reshape(
                b, s, cfg.n_kv_heads, cfg.head_dim)
            k = attn.apply_rope(k, positions, inv_freq)
            cache = (k, v)
        x = x + attn.attention_block(cfg, p["attn"], h, positions, inv_freq)
    else:
        y, _ = mam.apply_mamba(cfg, p["mamba"], h)
        x = x + y
    h2 = apply_norm(cfg, p["norm2"], x)
    if spec.ffn == "moe":
        y, aux = moe_mod.apply_moe(cfg, p["moe"], h2)
        x = x + y
    else:
        x = x + apply_mlp(cfg, p["mlp"], h2)
    return x, aux, cache


def forward_stack(cfg, blocks: list[dict], x: torch.Tensor,
                  positions: torch.Tensor, *, collect_cache: bool = False):
    """Run the period stack.  Returns (x, total aux loss, caches or
    None): per attention sublayer, (k, v) stacked over periods
    (n_periods, B, S, Hkv, hd)."""
    template = period_template(cfg)
    inv_freq = rope_freqs(cfg, x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    per_period = []
    for i in range(n_periods(cfg)):
        caches = []
        for si, spec in enumerate(template):
            x, aux, cache = _sublayer_forward(
                cfg, spec, period_params(blocks[si], i), x, positions,
                inv_freq,
                collect_cache=collect_cache and spec.mixer == "attn")
            total = total + aux
            if cache is not None:
                caches.append(cache)
        per_period.append(caches)
    if not collect_cache:
        return x, total, None
    stacked = tuple(
        (torch.stack([pc[j][0] for pc in per_period]),
         torch.stack([pc[j][1] for pc in per_period]))
        for j in range(len(per_period[0])))
    return x, total, stacked
