"""Training launcher CLI.

Port of ``src/repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --batch 8 --seq-len 256 [--reduced] [--device cpu] \\
        [--ckpt-dir artifacts/torch_train_ckpt] [--remat dots] \\
        [--opt-dtype bfloat16]

Drives the fault-tolerant runtime (checkpoint/restart, straggler
detection) over the synthetic pipeline with ``build_train_step``.  Runs
on the CUDA card unless ``--device cpu`` is given (without a card and
without ``--device`` it raises).  The initial parameters come from a
``torch.Generator`` seeded with ``--seed``, so they are not the JAX
PRNG's draws.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..data.pipeline import SyntheticLMPipeline
from ..device import resolve_device
from ..optim.adamw import AdamWConfig
from ..runtime.train_loop import TrainLoopConfig, device_batch, run_training
from .steps import build_train_step, init_train_state


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--ckpt-dir", default="artifacts/torch_train_ckpt")
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"({'reduced' if args.reduced else 'full'}) on {dev}")

    step_fn = build_train_step(
        cfg, AdamWConfig(lr=args.lr, warmup_steps=10,
                         total_steps=args.steps),
        remat=args.remat)
    pipeline = SyntheticLMPipeline(cfg.vocab_size, args.seq_len,
                                   args.batch, seed=args.seed)

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return init_train_state(cfg, gen, dev, args.opt_dtype)

    rep = run_training(
        step_fn, init_state, pipeline, args.ckpt_dir,
        TrainLoopConfig(total_steps=args.steps,
                        ckpt_interval=args.ckpt_interval),
        on_straggler=lambda s, dt: print(f"[straggler] step {s}: {dt:.2f}s"),
        to_batch=lambda b: device_batch(b, dev))
    print(f"steps={rep.steps_run} final_loss={rep.final_loss:.4f} "
          f"restarts={rep.restarts} stragglers={rep.stragglers} "
          f"resumed_from={rep.resumed_from}")
    if rep.losses:
        curve = np.asarray(rep.losses[::max(1, len(rep.losses) // 8)])
        print(f"loss curve: {np.array2string(curve, precision=3)}")


if __name__ == "__main__":
    main()
