#!/usr/bin/env python3
"""Host cost of one span of :mod:`repro_torch.obs`, off and on.

    python3 tools/span_cost.py [--calls N]

Times ``N`` spans (with and without attributes) and ``N`` counter adds
with the recorder off, the same with it on and no profiler running, and
a bare ``torch.profiler.record_function`` with no profiler running,
which is what a span would cost if it opened one unconditionally.  Each
figure is the best of five loops less an empty loop, in microseconds a
call.  Prints one line each and the host's CPU.  Needs no card.
"""
from __future__ import annotations

import argparse
import pathlib
import platform
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=200_000)
    n = ap.parse_args().calls
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch import obs

    def best_us(fn) -> float:
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t)
            obs.reset()
        return best / n * 1e6

    def empty():
        for _ in range(n):
            pass

    def span_attrs():
        for _ in range(n):
            with obs.span("matmul.stream", w="attn/wq", layer=3):
                pass

    def span():
        for _ in range(n):
            with obs.span("logits_copy"):
                pass

    def count():
        for _ in range(n):
            obs.count("logits_copy_bytes", 8)

    def record_function():
        for _ in range(n):
            with torch.profiler.record_function("repro.x"):
                pass

    base = best_us(empty)
    for state in ("off", "on"):
        if state == "on":
            obs.enable()
        print(f"{state}: span with attributes "
              f"{best_us(span_attrs) - base:.4f} us, span "
              f"{best_us(span) - base:.4f} us, count "
              f"{best_us(count) - base:.4f} us")
    obs.disable()
    obs.reset()
    print(f"record_function, no profiler: "
          f"{best_us(record_function) - base:.4f} us")
    print(f"host: {platform.processor() or platform.machine()}, "
          f"python {platform.python_version()}, torch {torch.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
