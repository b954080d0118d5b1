"""Design-space exploration with Iris (paper §1: "rapid design-space
exploration while tuning the width of custom-precision data types").

Port of the reference's ``examples/layout_explorer.py``; prints the same
four tables.  Everything drives the :mod:`repro_torch.api` façade: the
per-strategy comparison iterates the strategy registry, the sweeps run
through the shared layout cache, and the serving-stream DSE reuses the
layer-stack planner.  Host planning only: no tensor is put on any device.

Run:  PYTHONPATH=src python -m repro_torch.examples.layout_explorer
      [--arch smollm-135m]
"""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core.dse import sweep_max_lanes, sweep_widths
from repro_torch.plan import serving_stream_report
from repro_torch.quant import QuantSpec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    args = ap.parse_args(argv)

    print("=== Strategy registry on the §4 example (Figs. 3-5) ===")
    print(f"{'strategy':>12s} {'C_max':>6s} {'L_max':>6s} {'B_eff':>7s}")
    for name, m in api.compare(api.PAPER_EXAMPLE).items():
        print(f"{name:>12s} {m.c_max:>6d} {m.l_max:>6d} "
              f"{m.efficiency:>7.1%}")

    print("\n=== Custom-precision width sweep (paper Table 7 style) ===")
    print(f"{'widths':>12s} {'naive eff':>10s} {'iris eff':>10s} "
          f"{'iris C_max':>10s} {'iris L_max':>10s}")
    for row in sweep_widths(api.matmul_problem, [(64, 64), (48, 40), (33, 31),
                                                 (30, 19), (17, 13)]):
        print(f"{row['widths']!s:>12s} {row['naive_eff']:>10.3f} "
              f"{row['iris_eff']:>10.3f} {row['iris_cmax']:>10d} "
              f"{row['iris_lmax']:>10d}")

    print("\n=== delta/W constraint sweep (paper Table 6 style) ===")
    print(f"{'d/W':>4s} {'eff':>8s} {'L_max':>7s} {'fifo':>8s}")
    for row in sweep_max_lanes(api.INV_HELMHOLTZ, [None, 4, 3, 2, 1]):
        print(f"{str(row['max_lanes']):>4s} {row['eff']:>8.3f} "
              f"{row['lmax']:>7d} {row['fifo']:>8d}")

    print(f"\n=== Serving-stream DSE for {args.arch} ===")
    cfg = get_config(args.arch)
    print(f"{'bits':>4s} {'iris MiB/L':>11s} {'pad MiB/L':>10s} "
          f"{'bf16 MiB/L':>11s} {'B_eff':>7s}")
    for bits in (3, 4, 5, 6, 8):
        r = serving_stream_report(cfg, QuantSpec(bits=bits, group_size=128))
        print(f"{bits:>4d} {r['iris_MiB_per_layer']:>11.2f} "
              f"{r['padded_MiB_per_layer']:>10.2f} "
              f"{r['bf16_MiB_per_layer']:>11.2f} "
              f"{r['iris_efficiency']:>7.4f}")


if __name__ == "__main__":
    main()
