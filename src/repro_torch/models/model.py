"""Top-level model API for the dense, MoE and hybrid families.

Port of ``src/repro/models/model.py``: :class:`Model` with ``init``,
``_embed`` (``:74-79``), ``_logits`` (``:81-93``), ``forward``
(``:110-125``), ``init_decode_state`` (``:150-192``) and ``decode_step``
(``:194-264``).  A thin class over plain functions on tensors, as the
reference's is; parameters are the dict tree of
:func:`~repro_torch.models.params.init_params`.

Differences from the reference:

* ``loss`` comes with training (ROADMAP A14), ``encode`` and
  cross-attention with the encoder-decoder family (A13d).  Configs of the
  RWKV, encoder-decoder or VLM families raise ``NotImplementedError``.
* ``decode_step`` updates the state's caches **in place** and returns the
  same state dict with a new ``pos``; the reference returns new arrays.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import attention as attn
from . import mamba as mam
from .layers import apply_mlp, apply_norm, rope_freqs
from .moe import apply_moe
from .params import init_params
from .transformer import (
    check_supported,
    forward_stack,
    n_periods,
    period_params,
    period_template,
)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: object

    def __post_init__(self) -> None:
        check_supported(self.cfg)

    def init(self, generator: torch.Generator | None = None, *,
             device=None) -> dict:
        return init_params(self.cfg, generator, device=device)

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        emb = params["embed"]
        x = emb[tokens.to(device=emb.device, dtype=torch.int64)]
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                device=x.device)

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.cfg, params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["unembed"]

    def forward(self, params: dict, batch: dict, *,
                collect_cache: bool = False):
        """Prefill forward over ``batch["tokens"]`` (B, S).  Returns
        ``(logits (B, S, V), aux, caches)``: ``aux`` the MoE sublayers'
        summed load-balancing loss (an f32 scalar, 0 without experts);
        ``caches`` (with ``collect_cache``) per attention sublayer
        ``(k, v)``, each (n_periods, B, S, Hkv, hd), else None."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x, aux, caches = forward_stack(self.cfg, params["blocks"], x,
                                       positions,
                                       collect_cache=collect_cache)
        return self._logits(params, x), aux, caches

    def init_decode_state(self, batch_size: int, max_seq: int, *,
                          device=None) -> dict:
        """Per-row clocks ``pos`` (B,) int32; with an attention sublayer
        ``k_cache`` / ``v_cache`` (n_periods, B, max_seq, Hkv, hd) in the
        model dtype; with Mamba sublayers ``ssm`` (n_periods, n_mamba, B,
        H, d_state, head_dim) f32.  On ``device`` (``"cuda"`` unless
        given)."""
        cfg = self.cfg
        device = resolve_device(device)
        np_ = n_periods(cfg)
        template = period_template(cfg)
        state = {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                                    device=device)}
        n_attn = sum(t.mixer == "attn" for t in template)
        n_mamba = sum(t.mixer == "mamba" for t in template)
        if n_attn > 1:
            raise ValueError("cache layout assumes <= 1 attn sublayer/period")
        if n_attn:
            shape = (np_, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
            dtype = getattr(torch, cfg.dtype)
            state["k_cache"] = torch.zeros(shape, dtype=dtype, device=device)
            state["v_cache"] = torch.zeros(shape, dtype=dtype, device=device)
        if n_mamba:
            h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
            state["ssm"] = torch.zeros(
                (np_, n_mamba, batch_size, h, cfg.ssm.d_state,
                 cfg.ssm.head_dim), dtype=torch.float32, device=device)
        return state

    def decode_step(self, params: dict, state: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One decode token per row.  tokens: (B,) int.  Returns (logits
        (B, V) in the model dtype, state with the caches updated in place
        and ``pos + 1``)."""
        cfg = self.cfg
        template = period_template(cfg)
        pos = state["pos"]
        inv_freq = rope_freqs(cfg, pos.device)
        x = self._embed(params, tokens)[:, None]                  # (B, 1, d)
        for i in range(n_periods(cfg)):
            mi = 0
            for si, spec in enumerate(template):
                p = period_params(params["blocks"][si], i)
                h = apply_norm(cfg, p["norm1"], x)
                if spec.mixer == "attn":
                    x = x + attn.attention_decode_block(
                        cfg, p["attn"], h, state["k_cache"][i],
                        state["v_cache"][i], pos, inv_freq)
                else:
                    s = state["ssm"][i, mi]
                    y, s_new = mam.apply_mamba_step(cfg, p["mamba"], h[:, 0],
                                                    s)
                    s.copy_(s_new)
                    x = x + y[:, None].to(x.dtype)
                    mi += 1
                h2 = apply_norm(cfg, p["norm2"], x)
                if spec.ffn == "moe":
                    x = x + apply_moe(cfg, p["moe"], h2)[0]
                else:
                    x = x + apply_mlp(cfg, p["mlp"], h2)
        logits = self._logits(params, x)[:, 0]
        new_state = dict(state)
        new_state["pos"] = pos + 1
        return logits, new_state
