"""Model configurations for the port.

Own copy of ``src/repro/configs/base.py`` (:class:`MoEConfig`,
:class:`SSMConfig`, :class:`ModelConfig` with its layer-interleave
helpers, :meth:`ModelConfig.reduced` and :meth:`ModelConfig.with_tp`,
:class:`ShapeConfig` and
:data:`SHAPES`), of :func:`shape_cells`
(``src/repro/configs/__init__.py:35-42``) and of the reference's ten
config modules: ``smollm_135m``, ``mistral_large_123b``,
``command_r_plus_104b``, ``stablelm_3b``, ``moonshot_v1_16b_a3b``,
``arctic_480b``, ``jamba_1_5_large_398b``, ``rwkv6_3b``,
``whisper_medium`` and ``qwen2_vl_2b``, each field equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
import math


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
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64          # low-rank size of the data-dependent decay


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of an encoder-decoder model (whisper)."""

    n_layers: int
    n_ctx: int                    # encoder positions (audio frames)


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
    rwkv: RWKVConfig | None = None
    encoder: EncoderConfig | None = None
    attn_every: int = 1                     # jamba: 1 attn per N layers
    frontend: str | None = None             # None | "audio" | "vision"
    act: str = "silu"
    norm: str = "rmsnorm"
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] | None = None   # qwen2-vl M-RoPE
    max_seq_len: int = 1 << 19
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""                # "" = model dtype
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
        builds.  Unlike the reference's approximate count it includes
        each Mamba layer's ``w_bc``, ``w_dt`` and per-head vectors
        (ROADMAP §C), an RWKV layer's decay, bonus and mix vectors and
        its channel mix, the biases of a ``use_bias`` config and the
        LayerNorm biases."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        norm = d * (2 if self.norm == "layernorm" else 1)
        bias = 1 if self.use_bias else 0

        def mlp(ff: int) -> int:
            return 3 * d * ff + bias * (2 * ff + d)

        q, kv = self.n_heads * hd, self.n_kv_heads * hd
        attn = d * (q + 2 * kv) + q * d + bias * (q + 2 * kv + d)
        total = v * d * (1 if self.tie_embeddings else 2) + norm
        for i in range(self.n_layers):
            if self.rwkv is not None:
                # time mix: r, k, v, g, o; the decay LoRA; w0, u, 5 mixes
                total += 5 * d * d + 2 * d * self.rwkv.decay_lora + 7 * d
                # channel mix: k, v and its mix
                total += 2 * d * f + d + 2 * norm
                continue
            if self.layer_is_attn(i):
                total += attn
            elif self.ssm is not None:
                di = self.ssm.expand * d
                h = di // self.ssm.head_dim
                total += d * 2 * di + d * 2 * h * self.ssm.d_state + d * h
                total += 3 * h + di * d
            if self.layer_is_moe(i):
                moe = self.moe
                total += d * moe.n_experts
                total += moe.n_experts * 3 * d * moe.d_expert
                if moe.dense_residual_ff:
                    total += mlp(moe.dense_residual_ff)
            else:
                total += mlp(f)
            total += 2 * norm
        if self.encoder is not None:
            # the encoder's layers and final norm; a decoder layer's
            # cross-attention and its norm
            total += self.encoder.n_layers * (attn + mlp(f) + 2 * norm)
            total += norm + self.n_layers * (attn + norm)
        return total

    def active_param_count(self) -> int:
        """Parameters a token touches (MoE: its top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        moe = self.moe
        expert = sum(moe.n_experts * 3 * self.d_model * moe.d_expert
                     for i in range(self.n_layers) if self.layer_is_moe(i))
        return self.param_count() - int(
            expert * (1 - moe.top_k / moe.n_experts))

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU tests."""
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
        if self.rwkv is not None:
            changes["rwkv"] = dataclasses.replace(
                self.rwkv, head_dim=32, decay_lora=16)
        if self.encoder is not None:
            changes["encoder"] = dataclasses.replace(
                self.encoder, n_layers=2, n_ctx=32)
        if self.mrope_sections is not None:
            # rescale the sections to the reduced head_dim (hd/2 channels)
            hd = changes["head_dim"]
            total = sum(self.mrope_sections)
            t = self.mrope_sections[0] * (hd // 2) // total
            h = self.mrope_sections[1] * (hd // 2) // total
            changes["mrope_sections"] = (t, h, hd // 2 - t - h)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)

    def with_tp(self, tp: int) -> "ModelConfig":
        """Adjust for tensor parallelism (``src/repro/configs/base.py:196``):

        * replicate KV heads to a multiple of the model axis when
          n_kv_heads doesn't divide it (standard GQA TP practice);
        * pad the vocab to a multiple of the axis (Megatron-style) so
          the logits / CE path shards.

        The model function is unchanged (padded logit rows simply learn
        to be improbable; labels never reference them)."""
        out = self
        pad = (-out.vocab_size) % tp
        if pad:
            out = dataclasses.replace(out, vocab_size=out.vocab_size + pad)
        if out.n_kv_heads == 0 or out.n_kv_heads % tp == 0:
            return out
        reps = -(-tp // out.n_kv_heads)        # ceil
        new_kv = out.n_kv_heads * reps
        if new_kv % tp and tp % new_kv:
            # fall back: replicate to lcm so the axis divides or is unused
            new_kv = out.n_kv_heads * tp // math.gcd(out.n_kv_heads, tp)
        if out.n_heads % new_kv:
            return out                         # keep GQA grouping legal
        return dataclasses.replace(out, n_kv_heads=new_kv)


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

#: mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407:
#: 88L, d_model=12288, 96H (GQA kv=8), d_ff=28672, vocab=32768.
MISTRAL_LARGE_123B = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
)

#: command-r-plus-104b [dense] — hf:CohereForAI/c4ai-command-r-plus:
#: 64L, d_model=12288, 96H (GQA kv=8), d_ff=33792, vocab=256000,
#: LayerNorm, no biases.
COMMAND_R_PLUS_104B = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    norm="layernorm",
    use_bias=False,
    rope_theta=75_000_000.0,
    max_seq_len=131_072,
)

#: stablelm-3b [dense] — hf:stabilityai/stablelm-2 family: 32L,
#: d_model=2560, 32H (MHA: kv=32), d_ff=6912, vocab=50304, LayerNorm and
#: biased projections.
STABLELM_3B = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    use_bias=True,
    max_seq_len=32_768,
)

#: moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B: 48L,
#: d_model=2048, 16H (kv=16), d_ff=1408, vocab=163840; MoE 64 experts
#: top-6 (~3B active parameters per token).
MOONSHOT_V1_16B_A3B = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408),
    max_seq_len=131_072,
)

#: arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base: 35L,
#: d_model=7168, 56H (GQA kv=8), vocab=32000; MoE 128 experts top-2
#: (d_expert=4864) with a dense residual MLP in parallel.
ARCTIC_480B = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864,
                  dense_residual_ff=4864),
    max_seq_len=32_768,
)

#: rwkv6-3b [ssm] — Finch, arXiv:2404.05892 (attention-free): 32L,
#: d_model=2560, d_ff=8960, vocab=65536; RWKV-6 time mix with a
#: data-dependent per-channel decay, squared-relu channel mix.
RWKV6_3B = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,              # time-mix heads, head_dim 64
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    act="relu_squared",
    subquadratic=True,
    max_seq_len=1 << 20,
)

#: whisper-medium [audio enc-dec] — arXiv:2212.04356: 24L decoder (+24L
#: encoder), d_model=1024, 16H, d_ff=4096, vocab=51865, LayerNorm,
#: biases, sinusoidal positions.  The conv audio front end is a stub:
#: the encoder takes (B, 1500, d_model) frame embeddings.
WHISPER_MEDIUM = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    encoder=EncoderConfig(n_layers=24, n_ctx=1500),
    frontend="audio",
    act="gelu",
    norm="layernorm",
    use_bias=True,
    rope_theta=0.0,
    max_seq_len=32_768,
)

#: qwen2-vl-2b [vlm] — arXiv:2409.12191: 28L, d_model=1536, 12H (GQA
#: kv=2), d_ff=8960, vocab=151936, tied; M-RoPE (temporal / height /
#: width sections).  The vision front end is a stub.
QWEN2_VL_2B = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    frontend="vision",
    use_bias=True,
    tie_embeddings=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)

_REGISTRY = {c.name: c for c in (
    WHISPER_MEDIUM, COMMAND_R_PLUS_104B, MISTRAL_LARGE_123B, STABLELM_3B,
    SMOLLM_135M, ARCTIC_480B, MOONSHOT_V1_16B_A3B, RWKV6_3B,
    JAMBA_1_5_LARGE, QWEN2_VL_2B)}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(_REGISTRY)}")
    return _REGISTRY[arch]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_cells(arch: str) -> list[ShapeConfig]:
    """The runnable shape cells of an arch (``long_500k`` needs
    sub-quadratic attention)."""
    cfg = get_config(arch)
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        cells.append(SHAPES["long_500k"])
    return cells
