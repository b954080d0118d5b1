"""Model configurations for the port.

Own copy of the dense fields of ``src/repro/configs/base.py``
(:class:`ModelConfig` and :meth:`ModelConfig.reduced`) and of
``src/repro/configs/smollm_135m.py``.  Only what the packed serving path
reads is kept; the MoE / SSM / encoder families come with later slices.
"""
from __future__ import annotations

import dataclasses


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
    act: str = "silu"
    norm: str = "rmsnorm"
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    max_seq_len: int = 1 << 19
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.n_heads > 0:
            hd = self.head_dim or self.d_model // self.n_heads
            object.__setattr__(self, "head_dim", hd)
            if self.n_heads % max(1, self.n_kv_heads):
                raise ValueError("n_heads must be a multiple of n_kv_heads")

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU tests (the reference's
        ``reduced()`` for the dense family)."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            max_seq_len=256,
        )
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

_REGISTRY = {"smollm-135m": SMOLLM_135M}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(_REGISTRY)}")
    return _REGISTRY[arch]
