"""AdamW with decoupled weight decay, global-norm clipping and an LR
schedule.

Port of ``src/repro/optim/adamw.py``: :class:`AdamWConfig`,
:func:`lr_schedule`, :func:`init_opt_state`, :func:`global_norm`,
:func:`_decay_mask` and :func:`adamw_update`, over the port's dict trees
of tensors.  The state is two moment trees (f32, or bf16 to halve their
memory) and an int32 0-d ``step``; parameters may be bf16.  The update
runs in f32 and is cast back to each parameter's dtype.

Two things follow the reference exactly, because results depend on
them:

* Leaves are walked in ``jax.tree_util`` order (``repro_torch.pytree``),
  so :func:`global_norm` sums its per-leaf squares in the reference's
  order.
* The decay mask is the reference's rule on the same ``/``-joined,
  lowercased paths: no decay for leaves of ndim <= 1 or whose path holds
  one of ``_NO_DECAY_SUBSTRINGS``.  Stacked bias leaves such as
  ``attn/bq`` (P, N) *are* decayed there ("bias" is not a substring of
  "bq"), and so they are here.

The update makes new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..pytree import flatten, leaf_paths, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _recip(c: float) -> float:
    """The f32 reciprocal of a constant divisor: XLA rewrites the jitted
    reference's ``x / c`` into ``x * (1/c)`` (PyTorch's CUDA division by
    a Python scalar does the same), so the port multiplies on every
    device."""
    return float(np.float32(1.0) / np.float32(c))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac``; an f32 0-d
    tensor on ``step``'s device.  The Python constants fold in double
    precision and meet the f32 tensors in the reference's order; the
    divisions by constants are the jitted reference's multiplies."""
    step = step.to(torch.float32)
    warm = step * _recip(max(1.0, cfg.warmup_steps))
    prog = (step - cfg.warmup_steps) * _recip(max(
        1.0, cfg.total_steps - cfg.warmup_steps))
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any, moment_dtype: str = "float32") -> dict:
    """Zero moments ``m`` / ``v`` in ``moment_dtype`` (``"bfloat16"``
    halves their memory; the update math stays f32) beside each leaf, and
    ``step`` int32 0-d on the first leaf's device."""
    dt = getattr(torch, moment_dtype)
    leaves = flatten(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, the leaves in
    ``jax.tree_util`` order."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32)))
         for g in flatten(tree)])))


_NO_DECAY_SUBSTRINGS = ("norm", "bias", "scale", "mix", "bonus", "dt_bias",
                        "a_log", "decay_w0", "d_skip")


def _decay_mask(path: str, leaf) -> bool:
    """Whether weight decay applies to the leaf at ``path`` (its keys
    joined with ``/``)."""
    if getattr(leaf, "ndim", 0) <= 1:
        return False
    joined = path.lower()
    return not any(s in joined for s in _NO_DECAY_SUBSTRINGS)


def adamw_update(cfg: AdamWConfig, grads: Any, opt_state: dict,
                 params: Any,
                 transform_grads: Callable[[Any], Any] | None = None
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step.  Returns (new_params, new_opt_state, metrics):
    ``metrics`` holds ``grad_norm`` (before clipping) and ``lr``, f32 0-d
    tensors."""
    if transform_grads is not None:
        grads = transform_grads(grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    f32 = torch.float32

    def upd(path, p, g, m, v):
        mdt = m.dtype
        g = g.to(f32) * scale
        m = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g
        v = cfg.b2 * v.to(f32) + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if _decay_mask(path, p):
            delta = delta + cfg.weight_decay * p.to(f32)
        new_p = (p.to(f32) - lr * delta).to(p.dtype)
        return new_p, m.to(mdt), v.to(mdt)

    out = [upd(path, p, g, m, v) for path, p, g, m, v in zip(
        leaf_paths(params), flatten(params), flatten(grads),
        flatten(opt_state["m"]), flatten(opt_state["v"]))]
    opt_out = {"m": unflatten(params, [o[1] for o in out]),
               "v": unflatten(params, [o[2] for o in out]),
               "step": step}
    return (unflatten(params, [o[0] for o in out]), opt_out,
            {"grad_norm": gnorm, "lr": lr})
