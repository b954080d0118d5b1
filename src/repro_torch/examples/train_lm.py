"""Train a language model end to end with the fault-tolerant runtime.

Port of the reference's ``examples/train_lm.py``.  The default preset
trains a ~20M-param smollm-family model for 300 steps on the structured
synthetic stream (loss drops well below the unigram floor).  ``--preset
full`` uses the real smollm-135m config (~135M params), which the card
trains in well under a second a step; the CPU (``--device cpu``) runs
the default preset at a size it can finish.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm
      [--steps 300] [--preset full] [--device cpu]

Checkpoints go to ``--ckpt`` (``artifacts/torch_train_lm_ckpt``, not the
reference's directory); a second run on the same directory resumes and,
once trained to ``--steps``, has nothing to do.
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_train_step, init_train_state
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import (
    TrainLoopConfig,
    device_batch,
    run_training,
)

DEFAULT_CKPT = "artifacts/torch_train_lm_ckpt"


def config(preset: str, seq_len: int):
    """The preset's config: smollm-135m itself, or its ~20M-param cut."""
    base = get_config("smollm-135m")
    if preset == "full":
        return base
    return base.reduced(n_layers=6, d_model=384, n_heads=6, n_kv_heads=2,
                        d_ff=1024, vocab_size=2048, head_dim=64,
                        max_seq_len=seq_len)


def recipe(cfg, steps: int, seq_len: int, batch: int):
    """(AdamW config, pipeline, train-loop config) of a run of ``steps``."""
    opt = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    pipe = SyntheticLMPipeline(cfg.vocab_size, seq_len, batch, seed=0)
    loop = TrainLoopConfig(total_steps=steps,
                           ckpt_interval=max(10, steps // 6),
                           log_interval=10)
    return opt, pipe, loop


def train(cfg, steps: int, seq_len: int, batch: int, ckpt: str, device):
    """Train ``cfg`` under ``run_training`` on ``device`` from a state
    seeded 0, checkpointing into ``ckpt``.  Returns the ``TrainReport``."""
    opt, pipe, loop = recipe(cfg, steps, seq_len, batch)
    step_fn = build_train_step(cfg, opt)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        return init_train_state(cfg, gen, device)

    return run_training(step_fn, init_state, pipe,
                        str(pathlib.Path(ckpt)), loop,
                        to_batch=lambda b: device_batch(b, device))


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=["small", "full"], default="small")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = config(args.preset, args.seq_len)
    n_params = cfg.param_count()
    print(f"iris-repro PyTorch port (torch {torch.__version__}) on {device}")
    print(f"config: {cfg.n_layers}L d={cfg.d_model} "
          f"({n_params/1e6:.1f}M params), seq={args.seq_len}, "
          f"batch={args.batch}, steps={args.steps}")
    rep = train(cfg, args.steps, args.seq_len, args.batch, args.ckpt,
                device)
    ls = rep.losses
    uniform = float(np.log(cfg.vocab_size))
    print(f"restarts={rep.restarts} stragglers={rep.stragglers} "
          f"resumed_from={rep.resumed_from}")
    if not ls:
        print("nothing to do (already trained to --steps; "
              "use a fresh --ckpt to retrain)")
        return rep
    print(f"loss: start={ls[0]:.3f}  step50={ls[min(49, len(ls)-1)]:.3f}  "
          f"final={rep.final_loss:.3f}  (uniform={uniform:.3f})")
    tail = float(np.mean(ls[-10:]))
    assert tail < 0.8 * uniform, f"model failed to learn ({tail:.3f})"
    print("loss well below the uniform floor  [OK]")
    return rep


if __name__ == "__main__":
    main()
