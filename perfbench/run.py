"""The benchmark of the PyTorch / CUDA port, one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the cell's CUDA cards.
Prints the end-to-end metrics (``--trace 0``) or the per-layer metrics
(``--trace 1``) of the cell named in ``BENCHMARK.json`` as the last line
of standard output, one JSON object; the numbers compared for
``correct``, each with its limit, end standard error.  Exits non-zero,
printing no result, without enough CUDA cards, or if JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# run as a script, this file's folder leads sys.path: take it out, so that
# the harness's modules (``trace``, ``spec``, ...) never shadow others
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "perfbench":
    sys.path.pop(0)
#: modules the harness and the program may never load, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs(root: pathlib.Path) -> dict[str, str]:
    """Fixed cache directories inside the checkout: the planner's on-disk
    layout cache, and torch's extension and Triton caches.  The program's
    CUDA libraries are built in ``build/repro_torch/`` by the program."""
    base = root / "build" / "perfbench"
    return {"REPRO_CACHE_DIR": str(base / "layout_cache"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


#: one thread for the host's math libraries: the served path's host work is
#: one Python thread launching kernels, and idle pools of spinning threads
#: on a shared host only add to its noise
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}


def forbidden_loaded() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.update(cache_dirs(ROOT))
    os.environ.update(THREADS)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import spec
    from perfbench.cell import log, run_cell

    bench = spec.load_benchmark(ROOT)
    wl = spec.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        log(f"{args.workload} needs {wl['chips']} CUDA card(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    result, _ = run_cell(ROOT, bench, wl, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         device="cuda", t_start=T_START)
    bad = forbidden_loaded()
    if bad:
        log(f"loaded in this process: {bad}; the benchmark and the program "
            f"may load none of {FORBIDDEN}")
        return 3
    for name, c in result["checks"].items():
        side = "at least" if c.get("at_least") else "at most"
        log(f"check {name}: {c['value']!r} (limit: {side} {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
