"""Step functions the serve launcher and ``chip_smoke.py`` drive.

Port of ``src/repro/launch/steps.py:38-57``:

* ``prefill_step(params, batch)`` — forward logits + prefill KV caches
* ``serve_step(params, state, tokens, cross_kv=None)`` — one decode
  token (``cross_kv``: an encoder-decoder's cross K/V)

Built per config.  PyTorch runs eagerly, so there is nothing to jit;
``build_train_step`` comes with training (ROADMAP A14).
"""
from __future__ import annotations

from typing import Callable

from ..models.model import Model


def build_prefill_step(cfg) -> Callable:
    model = Model(cfg)

    def prefill_step(params: dict, batch: dict):
        logits, _aux, caches = model.forward(params, batch,
                                             collect_cache=True)
        return logits, caches

    return prefill_step


def build_serve_step(cfg) -> Callable:
    model = Model(cfg)

    def serve_step(params: dict, state: dict, tokens, cross_kv=None):
        return model.decode_step(params, state, tokens, cross_kv)

    return serve_step
