"""The readings a cell's limit is set from: the program's numbers and the
fp8 control's, seed after seed in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--out chiprun_out/calibrate.jsonl]

Each seed is a whole run of the cell (set-up, the loop at the cell's own
load for ``--seconds``, the sampled requests through the reference) that
also puts the control in the program's place over the same sample; one
JSON line per seed, with both sides' ``correct`` as the cell's checks
judge them at its limits.  For each number compared, the lower reading
is the largest ``served`` value over the seeds, the upper the smallest
``control`` value.  The benchmark's own runs never run this.
"""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "perfbench":
    sys.path.pop(0)


def main(argv=None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench.run import THREADS, cache_dirs

    os.environ.update(cache_dirs(ROOT))
    os.environ.update(THREADS)
    from perfbench import spec
    from perfbench.cell import run_cell

    bench = spec.load_benchmark(ROOT)
    wl = spec.workload(bench, args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            res, _ = run_cell(ROOT, bench, wl, seed=seed,
                              seconds=args.seconds, trace=False,
                              device="cuda",
                              t_start=time.perf_counter(), control=True)
            line = json.dumps({
                "workload": args.workload, "seed": seed,
                "correct": res["correct"],
                "control_correct": res["control_correct"],
                "served": res["served"], "control": res["control"],
                "tokens_compared": res["checks"]["tokens_compared"]["value"],
                "metrics": res["metrics"], "device": res["device"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
