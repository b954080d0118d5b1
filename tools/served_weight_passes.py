#!/usr/bin/env python3
"""Count the weight matmuls' launches and weight passes on a served step.

    python3 tools/served_weight_passes.py [--steps N] [--seed S] CELL...

For each cell of ``BENCHMARK.json`` (e.g. ``stablelm-3b-int3.conv64``),
builds the benchmark's served program as ``perfbench/cell.py`` does
(seeded weights, ``pack_tree``, the closed loop of the cell's clients),
primes it, runs the loop's warm-up steps, then counts, over ``--steps``
more steps, the launches of ``stream_matmul`` (B1) and ``packed_matmul``
(B2) and their ``weight_passes``: the gathers of a weight tile, one a
launch while a step has at most 64 rows.  Prints one line per kernel and
cell with the counts a step, then one JSON line.  Needs one CUDA card;
takes the cell's set-up (~1-2 min at full width) per cell.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def count(name: str, steps: int, seed: int) -> dict:
    """B1's and B2's launches and weight passes a step of cell ``name``."""
    import torch

    from perfbench import spec
    from perfbench.cell import build
    from perfbench.loop import ClosedLoop
    from perfbench.traffic import RequestSource
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm

    bench = spec.load_benchmark(ROOT)
    wl = spec.workload(bench, name)
    conf = spec.load_config(ROOT, bench, wl["config"])
    mix = spec.load_traffic(ROOT, wl["traffic"])
    shape = spec.ModelShape.from_config(conf)
    dev = torch.device("cuda")
    factory = build(shape, conf["quantization"], mix, seed, dev, {})
    loop = ClosedLoop(factory, RequestSource(mix, shape.vocab_size, seed),
                      mix["clients"])
    loop.prime()
    loop.start()
    loop.run_steps(mix["warm_steps"])
    torch.cuda.synchronize()
    before = {m: (m.launches, m.weight_passes) for m in (sm, pm)}
    loop.run_steps(steps)
    torch.cuda.synchronize()
    out = {}
    for mod, kernel in ((sm, "stream_matmul"), (pm, "packed_matmul")):
        launches = (mod.launches - before[mod][0]) / steps
        passes = (mod.weight_passes - before[mod][1]) / steps
        out[kernel] = {"launches": launches, "weight_passes": passes}
        print(f"{name} {kernel}: {launches} launches, {passes} weight "
              f"passes a step over {steps} steps")
    loop.engine = factory = None
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2147483011)
    args = ap.parse_args()
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench.run import THREADS, cache_dirs

    os.environ.update(cache_dirs(ROOT))
    os.environ.update(THREADS)
    import torch

    if not torch.cuda.is_available():
        print("served_weight_passes: no CUDA device", file=sys.stderr)
        return 2
    result = {name: count(name, args.steps, args.seed) for name in args.cells}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
