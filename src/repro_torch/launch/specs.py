"""Input specifications per (architecture x shape) cell.

Port of ``src/repro/launch/specs.py``.  Every function returns tensors on
``torch.device("meta")``, the counterpart of the reference's
``jax.ShapeDtypeStruct``: shapes and dtypes, no storage.  They are what
the dry run (``launch/dryrun.py``) counts costs against, and what the
data pipeline must produce at run time.  The decode cells include the
full KV / SSM state (the dominant memory term at 32k / 500k context).

The meta parameters come from the port's own ``init_params`` on the
meta device: its initializers touch no storage there, so no number is
drawn (:func:`abstract_params` checks that the generator did not move).
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs import ModelConfig, ShapeConfig
from ..models.model import Model
from ..models.transformer import n_periods

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (a torch dtype or its
    name)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch: dict[str, Any] = {
        "tokens": sds((b, s), torch.int32),
        "labels": sds((b, s), torch.int32),
    }
    if cfg.encoder is not None:
        batch["frames"] = sds((b, cfg.encoder.n_ctx, cfg.d_model),
                              torch.float32)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    batch = train_batch_specs(cfg, shape)
    batch.pop("labels")
    return batch


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta version of ``Model.init_decode_state`` + step inputs."""
    b, s = shape.global_batch, shape.seq_len
    state = Model(cfg).init_decode_state(b, max_seq=s, device=META)
    inputs: dict[str, Any] = {
        "state": state,
        "tokens": sds((b,), torch.int32),
    }
    if cfg.encoder is not None:
        hkv, hd = cfg.n_kv_heads, cfg.head_dim
        np_ = n_periods(cfg)
        ctx = cfg.encoder.n_ctx
        inputs["cross_kv"] = (
            sds((np_, b, ctx, hkv, hd), cfg.dtype),
            sds((np_, b, ctx, hkv, hd), cfg.dtype),
        )
    return inputs


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The non-parameter inputs of the step function for this cell."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    if shape.kind == "decode":
        return decode_state_specs(cfg, shape)
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def abstract_params(cfg: ModelConfig) -> Any:
    gen = torch.Generator()
    before = gen.get_state()
    params = Model(cfg).init(gen, device=META)
    assert torch.equal(gen.get_state(), before), "meta init drew numbers"
    return params


def abstract_train_state(cfg: ModelConfig,
                         opt_dtype: str = "float32") -> dict:
    from ..optim.adamw import init_opt_state

    params = abstract_params(cfg)
    return {"params": params, "opt": init_opt_state(params, opt_dtype)}
