"""Step functions the launchers and ``chip_smoke.py`` drive.

Port of ``src/repro/launch/steps.py``:

* ``train_step(state, batch)`` — loss, grads, AdamW update
* ``prefill_step(params, batch)`` — forward logits + prefill KV caches
* ``serve_step(params, state, tokens, cross_kv=None)`` — one decode
  token (``cross_kv``: an encoder-decoder's cross K/V)
* ``init_train_state(cfg, generator, device)`` — seeded params + zero
  AdamW state

Built per config.  PyTorch runs eagerly, so there is nothing to jit, and
it has no buffer donation: the train step makes a new state and leaves
the one it was given as it was, so the train loop can keep the old state
when a loss is not finite.

Sharded steps: where the reference jits a step with ``in_shardings``,
the port's steps take DTensor state placed by the rules of
``launch/sharding.py`` (``param_shardings``, ``opt_state_shardings``,
``decode_state_shardings``, ``batch_sharding``, then ``place``) and run
under an active mesh (``models.shard_utils.use_mesh``, or ``mesh=`` here,
which enters it around every call).  DTensor's sharding propagation
carries the placements through the model; the few ops it has no rule
for gather explicitly at that op (``shard_utils.unshard`` / ``local``,
each call site says why).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..models.model import Model
from ..models.shard_utils import use_mesh
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state
from ..pytree import flatten, unflatten


def _under(mesh):
    return contextlib.nullcontext() if mesh is None else use_mesh(mesh)


def build_train_step(cfg, opt_cfg: AdamWConfig | None = None,
                     remat: str = "full",
                     transform_grads: Callable | None = None, *,
                     mesh=None) -> Callable:
    """``train_step(state, batch) -> ({"params", "opt"}, metrics)``, with
    ``metrics`` the f32 0-d tensors ``loss``, ``grad_norm`` and ``lr``.
    The gradient of every leaf (zeros where the loss does not reach
    one, as ``jax.value_and_grad`` gives) goes to
    :func:`~repro_torch.optim.adamw.adamw_update`, after
    ``transform_grads`` (e.g. a ``GradCompressor`` round trip) if
    given."""
    opt_cfg = opt_cfg or AdamWConfig()
    model = Model(cfg, remat=remat)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        leaves = [p.detach().requires_grad_(True) for p in flatten(params)]
        with _under(mesh), torch.enable_grad():
            loss = model.loss(unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        with _under(mesh), torch.no_grad():
            new_params, new_opt, metrics = adamw_update(
                opt_cfg, unflatten(params, grads), state["opt"], params,
                transform_grads=transform_grads)
            new = _placed_as({"params": new_params, "opt": new_opt}, state)
        return new, {"loss": loss.detach(), **metrics}

    return train_step


def _placed_as(new: dict, old: dict) -> dict:
    """``new`` with each DTensor leaf redistributed to the placements of
    the same leaf of ``old``: the step's out shardings are its in
    shardings, as the reference jits them (DTensor would otherwise leave
    a replicated leaf that met a DP-sharded gradient ``Partial``)."""
    from ..models.shard_utils import is_dtensor

    leaves = [x.redistribute(x.device_mesh, o.placements)
              if is_dtensor(x) and is_dtensor(o)
              and x.placements != o.placements else x
              for x, o in zip(flatten(new), flatten(old))]
    return unflatten(new, leaves)


def build_prefill_step(cfg, *, mesh=None) -> Callable:
    model = Model(cfg)

    def prefill_step(params: dict, batch: dict):
        with _under(mesh):
            logits, _aux, caches = model.forward(params, batch,
                                                 collect_cache=True)
        return logits, caches

    return prefill_step


def build_serve_step(cfg, *, mesh=None) -> Callable:
    model = Model(cfg)

    def serve_step(params: dict, state: dict, tokens, cross_kv=None):
        with _under(mesh):
            return model.decode_step(params, state, tokens, cross_kv)

    return serve_step


def init_train_state(cfg, generator: torch.Generator | None = None,
                     device=None, moment_dtype: str = "float32") -> dict:
    """Seeded parameters (``Model.init`` from ``generator`` on ``device``,
    ``"cuda"`` unless given) and their zero AdamW state."""
    params = Model(cfg).init(generator, device=device)
    return {"params": params, "opt": init_opt_state(params, moment_dtype)}
