#!/usr/bin/env python3
"""Time the port's layout decodes and the whole-stack restore on one card.

    python3 tools/decode_timing.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so that one run on one card can time an older tree unpacked
elsewhere and this one, in turns.  Only entry points that both have are
called:

* ``decode_layout_fused`` of layer 0 of smollm-135m's int3 and int4
  trees (full width, 30 layers, seeded random weights), from the tree's
  device stream;
* the front door's per-slot decode, ``ops.decode_layout(fused=False)``,
  of one smollm layer as 14 element arrays (m 4096, 2170 units), from a
  device buffer;
* ``unpack_streams`` of each whole tree.

Each is timed back to back with CUDA events (host cost included) and on
the device: every device event of a ``torch.profiler`` window over the
call, with the number of events a call.  Prints the card, one line per
measurement, then one JSON line.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs              # its timers; it puts ROOT/src on
    sys.path.insert(0, args.src)         # the path, --src goes before it
    import torch

    if not torch.cuda.is_available():
        print("decode_timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import api
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.kernels.layout_decode import decode_layout_fused
    from repro_torch.kernels.ops import decode_layout
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree, unpack_streams

    src = pathlib.Path(repro_torch.__file__).resolve().parents[1]
    if src != pathlib.Path(args.src).resolve():
        raise RuntimeError(f"imported repro_torch from {src}, not {args.src}")
    card = cs.card_line()
    print(f"card: {card}; timing {args.label} ({src})")
    dev = torch.device("cuda")
    cfg = SMOLLM_135M
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    trees = [pack_tree(cfg, params, QuantSpec(bits=b, group_size=32),
                       device=dev) for b in (3, 4)]
    del params
    torch.cuda.synchronize()
    out = {"label": args.label, "card": card}

    def record(name, fn, iters):
        ms = cs.time_ms(fn, iters=iters, warmup=1)
        dms, events = cs.device_call(fn, iters=iters)
        out[name] = {"ms": ms, "device_ms": dms, "device_events": events}
        print(f"{name}: {ms:.4f} ms back to back, device {cs.fmt_ms(dms)} "
              f"ms over {events} device events a call")

    for tree in trees:
        record(f"decode_layout_fused int{tree.spec.bits} layer",
               lambda t=tree, p=tree.exec_program(), lay=tree.layout():
               decode_layout_fused(lay, t.streams[0], program=p), 30)
    specs = []
    for name, (k, n) in cs.layer_mats(cfg).items():
        specs += [(name, 3, k * n, 0), (f"{name}_scales", 16, k * n // 32, 0)]
    pl = api.plan(api.make_problem(4096, specs), cache=None)
    buf = torch.from_numpy(pl.pack(api.random_codes(pl.problem, seed=0))) \
        .to(dev)
    record(f"per-slot decode, {pl.decode_plan.n_units} units",
           lambda: decode_layout(pl.layout, buf, plan=pl.decode_plan,
                                 fused=False), 30)
    for tree in trees:
        t0 = time.perf_counter()
        unpack_streams(tree.manifest, tree.streams, tree.other, device=dev)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        record(f"unpack_streams int{tree.spec.bits}",
               lambda t=tree: unpack_streams(t.manifest, t.streams, t.other,
                                             device=dev), 2)
        out[f"unpack_streams int{tree.spec.bits}"]["first_call_ms"] = first
        print(f"unpack_streams int{tree.spec.bits}: first call {first:.1f} "
              f"ms wall")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
