"""Serving launcher CLI for the port (continuous batching, Iris-packed).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --packed --bits 3 [--reduced] [--device cpu]

Port of ``src/repro/launch/serve.py``, same flags plus ``--device``
(default ``cuda``).  ``--packed`` is required: the port serves the packed
path only (the dense model families come with a later slice).  Weights
are seeded random (``--seed``), quantized to ``--bits`` and packed into
per-layer Iris streams by :func:`repro_torch.tree.pack_tree`; every weight
matmul reads the streams directly, and the KV cache is a packed Iris
stream read by the stream attention kernel.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _run_open_loop(engine, requests, qps: float,
                   max_steps: int = 100_000) -> None:
    """Submit ``requests`` at ``qps`` arrivals/s on the wall clock while
    stepping the engine; drain after the last arrival."""
    t0 = time.monotonic()
    arrivals = [(i / qps, req) for i, req in enumerate(requests)]
    steps = 0
    while arrivals or engine.has_work():
        now = time.monotonic() - t0
        while arrivals and arrivals[0][0] <= now:
            engine.submit(arrivals.pop(0)[1])
        if engine.has_work():
            engine.step()
            steps += 1
            if steps >= max_steps:
                break
        elif arrivals:
            time.sleep(min(0.001, arrivals[0][0] - now))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--bits", type=int, default=8, choices=list(range(2, 9)),
                    help="quantization width of the packed weights and KV")
    ap.add_argument("--policy", choices=["continuous", "static"],
                    default="continuous")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop arrival rate (requests/s); 0 = closed "
                         "loop (submit all up front, drain)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine metrics JSON snapshot here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..engine import Engine, EngineConfig, EngineRequest, PackedAdapter
    from ..models.params import init_params
    from ..models.quantized import bytes_per_token_report, quantizable
    from ..quant import QuantSpec
    from ..tree import pack_tree

    if not args.packed:
        raise SystemExit("the port serves the packed path only: pass "
                         "--packed")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not quantizable(cfg):
        raise SystemExit(f"{cfg.name}: packed path covers dense archs")
    params = init_params(
        cfg, torch.Generator(device=args.device).manual_seed(args.seed),
        device=args.device)
    rng = np.random.default_rng(args.seed)
    qspec = QuantSpec(bits=args.bits, group_size=32)
    pt = pack_tree(cfg, params, qspec, device=args.device)
    del params
    rep = bytes_per_token_report(cfg, pt)
    print(f"weight stream/token: packed={rep['packed_MiB']:.2f} MiB "
          f"padded-int={rep['padded_int_MiB']:.2f} "
          f"bf16={rep['bf16_MiB']:.2f} "
          f"({rep['bf16_MiB'] / rep['packed_MiB']:.2f}x reduction)")
    print(pt.summary())
    print(f"serving path: stream-direct (int{args.bits}), packed int"
          f"{args.bits} KV")
    adapter = PackedAdapter(cfg, pt, kv="packed", kv_bits=args.bits)
    engine = Engine(adapter, EngineConfig(
        batch_size=args.batch_size, max_seq=args.max_seq,
        max_backlog=None, policy=args.policy))
    requests = []
    for uid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              rng.integers(2, 6)).tolist()
        requests.append(EngineRequest(uid=uid, prompt=prompt,
                                      max_new_tokens=args.max_new))
    if args.qps > 0:
        _run_open_loop(engine, requests, args.qps)
    else:
        for req in requests:
            engine.submit(req)
        engine.run_until_drained(max_steps=5000)
    stats = engine.stats
    print(f"completed={stats.completed}/{args.requests} "
          f"steps={stats.steps} tokens={stats.tokens_generated} "
          f"admitted={stats.admitted}")
    snap = engine.metrics.snapshot()
    lat = snap["latency"]["total"]
    thr = snap["throughput"]
    print(f"latency p50={lat['p50_s'] * 1e3:.1f}ms "
          f"p99={lat['p99_s'] * 1e3:.1f}ms "
          f"tokens/s={thr['tokens_per_s']:.1f} "
          f"occupancy={thr['mean_batch_occupancy']:.2f}")
    if args.metrics_out:
        engine.metrics.to_json(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    return snap


if __name__ == "__main__":
    main()
