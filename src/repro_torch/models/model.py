"""Top-level model API for every model family.

Port of ``src/repro/models/model.py``: :class:`Model` with ``init``,
``_embed`` (``:74-79``), ``_logits`` (``:81-93``), ``encode``
(``:95-107``), ``forward`` (``:110-125``), ``loss`` (``:127-147``),
``init_decode_state`` (``:150-185``), ``precompute_cross_kv``
(``:187-192``) and ``decode_step`` (``:194-264``).  A thin class over
plain functions on tensors, as the reference's is; parameters are the
dict tree of :func:`~repro_torch.models.params.init_params`.  ``remat``
(``"full"`` | ``"dots"`` | ``"none"``) is the rematerialization policy
``encode`` and ``forward`` hand to ``transformer.forward_stack``; it
acts only where a backward runs.

Differences from the reference:

* ``loss`` takes the label logit with a ``gather``; the reference
  contracts the logits with a one-hot (a vocab-sharding idiom).  For
  finite logits the value is the same bit for bit (one product by 1,
  the rest by 0), and no second (B, S, V) f32 tensor is made.
* ``decode_step`` updates the state's caches **in place** and returns the
  same state dict with a new ``pos``; the reference returns new arrays.
* Whisper's decode positions come from one sinusoidal table of
  ``max_seq_len`` rows per model and device, built on first use; the
  reference builds it on every step.  The values are the same.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import attention as attn
from . import mamba as mam
from . import rwkv as rwkv_mod
from .layers import apply_mlp, apply_norm, rope_freqs, sinusoidal_positions
from .moe import apply_moe
from .params import init_params
from .shard_utils import dp_spec, maybe_shard, unshard
from .transformer import (
    encoder_config,
    forward_stack,
    n_periods,
    period_params,
    period_template,
)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: object
    remat: str = "full"
    #: whisper's decode position table by device (built on first use)
    _tables: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def init(self, generator: torch.Generator | None = None, *,
             device=None) -> dict:
        return init_params(self.cfg, generator, device=device)

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        emb = params["embed"]
        x = emb[tokens.to(device=emb.device, dtype=torch.int64)]
        x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
        if x.ndim == 3:
            x = maybe_shard(x, dp_spec(), None, None)
        return x

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.cfg, params["final_norm"], x)
        if self.cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["unembed"]
        # vocab-parallel logits: keep V sharded over 'model' end to end
        if logits.ndim == 3:
            return maybe_shard(logits, dp_spec(), None, "model")
        return maybe_shard(logits, dp_spec(), "model")

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder: frame embeddings (B, n_ctx, d) (the stub of
        the audio front end) to the memory (B, n_ctx, d), non-causal."""
        cfg = self.cfg
        b, s, _ = frames.shape
        x = frames.to(getattr(torch, cfg.dtype))
        x = x + sinusoidal_positions(s, cfg.d_model, x.device) \
            .to(x.dtype)[None]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x, _, _ = forward_stack(encoder_config(cfg),
                                params["encoder"]["blocks"], x, positions,
                                causal=False, remat=self.remat)
        return apply_norm(cfg, params["encoder"]["final_norm"], x)

    def forward(self, params: dict, batch: dict, *,
                collect_cache: bool = False):
        """Prefill forward over ``batch["tokens"]`` (B, S), and for an
        encoder-decoder ``batch["frames"]`` (B, n_ctx, d).  Returns
        ``(logits (B, S, V), aux, caches)``: ``aux`` the MoE sublayers'
        summed load-balancing loss (an f32 scalar, 0 without experts);
        ``caches`` (with ``collect_cache``) per attention sublayer
        ``(k, v)``, each (n_periods, B, S, Hkv, hd), else None."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        cross_memory = None
        if cfg.encoder is not None:
            cross_memory = self.encode(params, batch["frames"].to(x.device))
            if cfg.rope_theta == 0.0:
                x = x + sinusoidal_positions(s, cfg.d_model, x.device) \
                    .to(x.dtype)[None]
        x, aux, caches = forward_stack(cfg, params["blocks"], x, positions,
                                       cross_memory=cross_memory,
                                       collect_cache=collect_cache,
                                       remat=self.remat)
        return self._logits(params, x), aux, caches

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy over f32 logits plus 0.01 x the
        MoE aux loss: an f32 scalar.  ``batch["labels"]`` (B, S) int;
        with ``batch["loss_mask"]`` (B, S) the CE is masked and divided
        by the mask's sum (at least 1), else by B * S."""
        logits, aux, _ = self.forward(params, batch)
        # explicit gather: DTensor's rule for a gather along a sharded
        # vocab dim fails (its masked partial reads a 2-D mask on 3-D
        # logits), so vocab-parallel logits are gathered whole here
        logits = unshard(logits, -1).to(torch.float32)
        labels = batch["labels"].to(device=logits.device, dtype=torch.int64)
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = lse - label_logit
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask.to(device=ce.device, dtype=ce.dtype)
            ce = ce * mask
            denom = torch.clamp(mask.sum(), min=1.0)
        else:
            denom = ce.numel()
        return ce.sum() / denom + 0.01 * aux

    def init_decode_state(self, batch_size: int, max_seq: int, *,
                          device=None) -> dict:
        """Per-row clocks ``pos`` (B,) int32; with an attention sublayer
        ``k_cache`` / ``v_cache`` (n_periods, B, max_seq, Hkv, hd) in
        ``kv_cache_dtype`` (the model dtype by default); with Mamba
        sublayers ``ssm`` (n_periods, n_mamba, B, H, d_state, head_dim)
        f32; with RWKV ``rwkv`` (n_periods, B, H, hd, hd) f32 and the
        shifts ``shift_t`` / ``shift_c`` (n_periods, B, d) in the model
        dtype.  On ``device`` (``"cuda"`` unless given)."""
        cfg = self.cfg
        device = resolve_device(device)
        np_ = n_periods(cfg)
        template = period_template(cfg)
        dtype = getattr(torch, cfg.dtype)
        state = {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                                    device=device)}
        n_attn = sum(t.mixer == "attn" for t in template)
        n_mamba = sum(t.mixer == "mamba" for t in template)
        n_rwkv = sum(t.mixer == "rwkv" for t in template)
        if n_attn > 1:
            raise ValueError("cache layout assumes <= 1 attn sublayer/period")
        if n_attn:
            shape = (np_, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
            kv_dtype = getattr(torch, cfg.kv_cache_dtype or cfg.dtype)
            state["k_cache"] = torch.zeros(shape, dtype=kv_dtype,
                                           device=device)
            state["v_cache"] = torch.zeros(shape, dtype=kv_dtype,
                                           device=device)
        if n_mamba:
            h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
            state["ssm"] = torch.zeros(
                (np_, n_mamba, batch_size, h, cfg.ssm.d_state,
                 cfg.ssm.head_dim), dtype=torch.float32, device=device)
        if n_rwkv:
            hd = cfg.rwkv.head_dim
            state["rwkv"] = torch.zeros(
                (np_, batch_size, cfg.d_model // hd, hd, hd),
                dtype=torch.float32, device=device)
            for key in ("shift_t", "shift_c"):
                state[key] = torch.zeros((np_, batch_size, cfg.d_model),
                                         dtype=dtype, device=device)
        return state

    def precompute_cross_kv(self, params: dict, memory: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """The decoder's cross K/V of the encoder ``memory`` (B, ctx, d):
        (n_periods, B, ctx, Hkv, hd) each."""
        cross = params["blocks"][0]["cross"]            # encdec: 1 sublayer
        kvs = [attn.cross_kv(self.cfg, period_params(cross, i), memory)
               for i in range(n_periods(self.cfg))]
        return (torch.stack([k for k, _ in kvs]),
                torch.stack([v for _, v in kvs]))

    def _decode_positions(self, pos: torch.Tensor) -> torch.Tensor:
        """Rows ``pos`` of the (max_seq_len, d) sinusoidal table.  A row
        past the table (an idle engine slot stepping on; its logits are
        discarded) takes the last row, where the reference's ``take``
        fills NaN."""
        key = str(pos.device)
        if key not in self._tables:
            self._tables[key] = sinusoidal_positions(
                self.cfg.max_seq_len, self.cfg.d_model, pos.device)
        tab = self._tables[key]
        return tab[pos.to(torch.int64).clamp(max=tab.shape[0] - 1)]

    def decode_step(self, params: dict, state: dict, tokens: torch.Tensor,
                    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """One decode token per row.  tokens: (B,) int; ``cross_kv`` the
        encoder memory's K/V from :meth:`precompute_cross_kv` (without it
        the decoder skips its cross-attention, as the reference's does).
        Returns (logits (B, V) in the model dtype, state with the caches
        updated in place and ``pos + 1``)."""
        cfg = self.cfg
        template = period_template(cfg)
        pos = state["pos"]
        inv_freq = rope_freqs(cfg, pos.device)
        x = self._embed(params, tokens)[:, None]                  # (B, 1, d)
        if cfg.rope_theta == 0.0 and cfg.encoder is not None:
            x = x + self._decode_positions(pos).to(x.dtype)[:, None]
        for i in range(n_periods(cfg)):
            mi = 0
            for si, spec in enumerate(template):
                p = period_params(params["blocks"][si], i)
                h = apply_norm(cfg, p["norm1"], x)
                if spec.mixer == "attn":
                    x = x + attn.attention_decode_block(
                        cfg, p["attn"], h, state["k_cache"][i],
                        state["v_cache"][i], pos, inv_freq)
                elif spec.mixer == "mamba":
                    s = state["ssm"][i, mi]
                    y, s_new = mam.apply_mamba_step(cfg, p["mamba"], h[:, 0],
                                                    s)
                    s.copy_(s_new)
                    x = x + y[:, None].to(x.dtype)
                    mi += 1
                else:
                    y, s_new, sh = rwkv_mod.apply_rwkv_time_mix_step(
                        cfg, p["rwkv_t"], h[:, 0], state["shift_t"][i],
                        state["rwkv"][i])
                    state["rwkv"][i].copy_(s_new)
                    state["shift_t"][i].copy_(sh)
                    x = x + y[:, None].to(x.dtype)
                if spec.cross and cross_kv is not None:
                    hc = apply_norm(cfg, p["norm_cross"], x)
                    x = x + attn.cross_attention_block(
                        cfg, p["cross"], hc,
                        kv=(cross_kv[0][i], cross_kv[1][i]))
                h2 = apply_norm(cfg, p["norm2"], x)
                if spec.ffn == "moe":
                    x = x + apply_moe(cfg, p["moe"], h2)[0]
                elif spec.ffn == "mlp":
                    x = x + apply_mlp(cfg, p["mlp"], h2)
                else:
                    y, sh = rwkv_mod.apply_rwkv_channel_mix_step(
                        cfg, p["rwkv_c"], h2[:, 0], state["shift_c"][i])
                    state["shift_c"][i].copy_(sh)
                    x = x + y[:, None].to(x.dtype)
        logits = self._logits(params, x)[:, 0]
        new_state = dict(state)
        new_state["pos"] = pos + 1
        return logits, new_state
