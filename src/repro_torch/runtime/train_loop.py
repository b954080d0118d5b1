"""Fault-tolerant training loop.

Port of ``src/repro/runtime/train_loop.py`` over the port's dense
:class:`~repro_torch.checkpoint.CheckpointManager` (which snapshots the
state to the host at ``save_async`` and writes it on a thread):

* **checkpoint/restart** — an async save every ``ckpt_interval`` steps
  (and at the last), the pipeline's state in its ``extra``; a run starts
  from the latest complete checkpoint in ``ckpt_dir``;
* **node-failure recovery** — a step that raises is retried from the last
  checkpoint, up to ``max_restarts`` times;
* **straggler mitigation** — a step slower than ``straggler_factor`` x
  the EWMA of step wall times is counted and handed to ``on_straggler``;
  the EWMA starts at the second step (the first carries warm-up);
* **NaN/overflow guard** — a non-finite loss skips the update: the state
  of the previous step is kept.

Restores place the leaves on the device of the state ``init_state_fn``
returns.  One deliberate difference: before recovery reads the latest
step, it waits for the queued saves.  The reference reads it at once, so
under load it can miss a save still being written and restart from an
older step (or step 0).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..data.pipeline import SyntheticLMPipeline
from ..pytree import flatten


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_interval: int = 25
    keep_n: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    log_interval: int = 10


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_loss: float
    losses: list
    restarts: int
    stragglers: int
    skipped_nonfinite: int
    resumed_from: int | None


def device_batch(batch: dict, device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``: ``tokens`` as
    int64 (the embedding's index dtype), the rest (``labels`` int32) in
    their dtypes."""
    return {k: torch.from_numpy(np.asarray(v)).to(
        device, dtype=torch.int64 if k == "tokens" else None)
        for k, v in batch.items()}


def _restore(mgr: CheckpointManager, state: Any, step: int) -> tuple:
    leaves = flatten(state)
    device = leaves[0].device if leaves else torch.device("cpu")
    return mgr.restore(state, step=step, device=device)


def run_training(
    step_fn: Callable[[Any, dict], tuple[Any, dict]],
    init_state_fn: Callable[[], Any],
    pipeline: SyntheticLMPipeline,
    ckpt_dir: str,
    cfg: TrainLoopConfig = TrainLoopConfig(),
    on_straggler: Callable[[int, float], None] | None = None,
    fail_injector: Callable[[int], None] | None = None,
    to_batch: Callable[[dict], dict] | None = None,
) -> TrainReport:
    """Drive ``step_fn`` to ``total_steps`` with full fault handling.

    ``to_batch`` maps each pipeline batch before the step (e.g. onto the
    card).  ``fail_injector(step)`` (tests only) may raise to simulate
    node loss.
    """
    mgr = CheckpointManager(ckpt_dir, keep_n=cfg.keep_n)
    state = init_state_fn()
    resumed_from = None
    latest = mgr.latest_step()
    if latest is not None:
        state, extra = _restore(mgr, state, latest)
        pipeline.load_state_dict(extra["pipeline"])
        resumed_from = latest

    losses: list[float] = []
    restarts = stragglers = skipped = 0
    ewma: float | None = None
    step = pipeline.state.step

    while step < cfg.total_steps:
        t0 = time.monotonic()
        try:
            if fail_injector is not None:
                fail_injector(step)
            batch = pipeline.next_batch()
            if to_batch is not None:
                batch = to_batch(batch)
            new_state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                skipped += 1
                step += 1
                continue                      # keep previous state
            state = new_state
            losses.append(loss)
        except KeyboardInterrupt:             # pragma: no cover
            raise
        except Exception:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise
            # node failure path: reload the last good checkpoint and the
            # data state, once the queued saves are on disk
            mgr.wait()
            latest = mgr.latest_step()
            state = init_state_fn()
            if latest is not None:
                state, extra = _restore(mgr, state, latest)
                pipeline.load_state_dict(extra["pipeline"])
            else:
                pipeline.load_state_dict({"seed": pipeline.state.seed,
                                          "step": 0})
            step = pipeline.state.step
            continue

        dt = time.monotonic() - t0
        if ewma is not None and dt > cfg.straggler_factor * ewma:
            stragglers += 1
            if on_straggler is not None:
                on_straggler(step, dt)
        if len(losses) >= 2:
            ewma = dt if ewma is None else (
                cfg.ewma_alpha * dt + (1 - cfg.ewma_alpha) * ewma)

        step += 1
        if step % cfg.ckpt_interval == 0 or step == cfg.total_steps:
            mgr.save_async(step, state,
                           extra={"pipeline": pipeline.state_dict()})
    mgr.wait()
    return TrainReport(
        steps_run=len(losses),
        final_loss=losses[-1] if losses else float("nan"),
        losses=losses,
        restarts=restarts,
        stragglers=stragglers,
        skipped_nonfinite=skipped,
        resumed_from=resumed_from,
    )
