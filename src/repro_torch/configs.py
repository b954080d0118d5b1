"""Model configurations for the port.

Own copy of ``src/repro/configs/base.py`` (:class:`MoEConfig`,
:class:`SSMConfig`, :class:`ModelConfig` with its layer-interleave
helpers and :meth:`ModelConfig.reduced`), of
``src/repro/configs/smollm_135m.py`` and of
``src/repro/configs/jamba_1_5_large_398b.py``.  The RWKV, encoder and
M-RoPE fields come with the families that read them (ROADMAP A13);
:class:`MoEConfig` is kept as a type so that jamba's configuration reads
as the reference's, and the model path refuses it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    capacity_factor: float = 1.25
    dense_residual_ff: int | None = None
    every: int = 1                # jamba: alternate dense/MoE


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-family SSM block in SSD (scalar-decay head) form."""

    d_state: int = 64             # state per head (dk = d_state)
    expand: int = 2               # d_inner = expand * d_model
    head_dim: int = 64            # dv


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                       # 0 -> d_model // n_heads
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 1                     # jamba: 1 attn per N layers
    act: str = "silu"
    norm: str = "rmsnorm"
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    max_seq_len: int = 1 << 19
    dtype: str = "bfloat16"
    subquadratic: bool = False              # eligible for long contexts

    def __post_init__(self) -> None:
        if self.n_heads > 0:
            hd = self.head_dim or self.d_model // self.n_heads
            object.__setattr__(self, "head_dim", hd)
            if self.n_heads % max(1, self.n_kv_heads):
                raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_is_attn(self, layer_idx: int) -> bool:
        """Hybrid interleave: layer i uses attention iff this is True."""
        if self.attention_free:
            return False
        if self.attn_every <= 1:
            return True
        # jamba: one attention layer per `attn_every`, at a period's end
        return layer_idx % self.attn_every == self.attn_every - 1

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx % self.moe.every == self.moe.every - 1

    def param_count(self) -> int:
        """Parameters of the tree that ``models.params.init_params``
        builds (dense and hybrid families without experts).  Unlike the
        reference's approximate count it includes each Mamba layer's
        ``w_bc``, ``w_dt`` and per-head vectors (ROADMAP §C)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        total = v * d * (1 if self.tie_embeddings else 2) + d
        for i in range(self.n_layers):
            if self.layer_is_attn(i):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
            elif self.ssm is not None:
                di = self.ssm.expand * d
                h = di // self.ssm.head_dim
                total += d * 2 * di + d * 2 * h * self.ssm.d_state + d * h
                total += 3 * h + di * d
            total += 3 * d * f + 2 * d
        return total

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU tests (the reference's
        ``reduced()`` for the dense and hybrid families)."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 2 if self.attn_every <= 1
                         else 2 * self.attn_every),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            max_seq_len=256,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_expert=64,
                dense_residual_ff=(64 if self.moe.dense_residual_ff else None),
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


#: smollm-135m [dense] — hf:HuggingFaceTB/SmolLM-135M (llama-arch small):
#: 30L, d_model=576, 9H (GQA kv=3), d_ff=1536, vocab=49152, tied embeddings.
SMOLLM_135M = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    max_seq_len=32_768,
)

#: jamba-1.5-large-398b [hybrid] — arXiv:2403.19887: 72L, d_model=8192,
#: 64H (GQA kv=8), d_ff=24576, vocab=65536; Mamba+attention 1:7
#: interleave (1 attention layer per 8), MoE 16 experts top-2 on every
#: second layer.
JAMBA_1_5_LARGE = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attn_every=8,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, every=2),
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64),
    subquadratic=True,
    max_seq_len=1 << 20,
)

_REGISTRY = {c.name: c for c in (SMOLLM_135M, JAMBA_1_5_LARGE)}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(_REGISTRY)}")
    return _REGISTRY[arch]
