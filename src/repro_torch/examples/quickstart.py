"""Quickstart: the Iris layout pipeline end to end in about a minute.

Port of the reference's ``examples/quickstart.py``:

1. Solve the paper's §4 worked example under every registered layout
   strategy through the :mod:`repro_torch.api` façade and print the
   metrics.
2. Pack real data into the Iris layout and decode it through both
   registered decode backends (the numpy oracle and the ``cuda`` backend:
   the fused decode kernel on the card, its plain PyTorch version with
   ``--device cpu``), asserting bit-for-bit agreement.
3. Train a tiny LM for a few steps with the full fault-tolerant runtime
   (``build_train_step`` on the device, the batches moved there).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import api
from repro_torch.device import resolve_device


def strategies_section() -> api.Plan:
    """§1: every strategy's C_max, L_max and B_eff, then the Iris plan's
    render.  Returns the validated Iris plan."""
    print("=== 1. Paper §4 example (every registered strategy) ===")
    for name in api.strategies():
        m = api.plan(api.PAPER_EXAMPLE, name).metrics
        print(f"{name:12s} C_max={m.c_max:3d}  L_max={m.l_max:3d}  "
              f"B_eff={m.efficiency:.1%}")
    pl = api.plan(api.PAPER_EXAMPLE).validate()
    print("\nIris layout (rows = bus cycles, letters = arrays):")
    print(pl.render())
    return pl


def roundtrip_section(pl: api.Plan, device) -> dict[str, np.ndarray]:
    """§2: pack seeded codes on the host, decode them with the ``numpy``
    and ``cuda`` backends (on ``device``), and assert both equal the
    codes.  Returns the codes."""
    print("\n=== 2. Pack + decode roundtrip (numpy and cuda backends) ===")
    codes = api.random_codes(pl.problem, seed=42)
    buf = pl.pack(codes)
    print(f"packed buffer: {buf.shape[0]} cycles x {buf.shape[1]} bytes")
    outs = {"numpy": pl.decode(buf, backend="numpy"),
            "cuda": pl.decode(buf, backend="cuda", device=device)}
    for name, want in codes.items():
        for backend, out in outs.items():
            assert np.array_equal(out[name], want), (backend, name)
    print("numpy == cuda == original data for all arrays  [OK]")
    return codes


def training_section(device, steps: int = 60):
    """§3: a tiny smollm-family LM trained for ``steps`` steps under
    ``run_training`` (checkpoints in a temporary directory).  Returns
    the ``TrainReport``."""
    print("\n=== 3. Tiny fault-tolerant training run ===")
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import (
        TrainLoopConfig,
        device_batch,
        run_training,
    )

    cfg = get_config("smollm-135m").reduced(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        vocab_size=64, head_dim=32)
    step_fn = build_train_step(
        cfg, AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=steps))
    pipe = SyntheticLMPipeline(64, 32, 4, seed=0)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        return init_train_state(cfg, gen, device)

    with tempfile.TemporaryDirectory() as ckpt:
        rep = run_training(
            step_fn, init_state, pipe, ckpt,
            TrainLoopConfig(total_steps=steps, ckpt_interval=20),
            to_batch=lambda b: device_batch(b, device))
    first = sum(rep.losses[:5]) / 5
    last = sum(rep.losses[-5:]) / 5
    print(f"loss (5-step mean): {first:.3f} -> {last:.3f} "
          f"over {rep.steps_run} steps  "
          f"[{'OK' if last < first else 'noisy'}]")
    return rep


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    pl = strategies_section()
    roundtrip_section(pl, device)
    return training_section(device)


if __name__ == "__main__":
    main()
