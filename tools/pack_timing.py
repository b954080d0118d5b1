#!/usr/bin/env python3
"""Time the port's layout pack, per layer and over a whole stack, on one card.

    python3 tools/pack_timing.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so that one run on one card can time an older tree unpacked
elsewhere and this one, in turns (parent, change, change, parent).  Only
entry points that both have are called:

* ``pack_tree`` of smollm-135m at int3 and at int4 (full width, 30
  layers, seeded random weights), timed whole: quantization, the planned
  layout's lowering (a cache hit after the first call) and 30 packs;
* ``pack_pieces`` of layer 0 of each tree, with the pieces as
  ``pack_tree`` hands them over (each layer's uint8 codes and int32 bf16
  bit patterns, kept by wrapping ``repro_torch.tree.pack_pieces`` during
  the first ``pack_tree``);
* ``pack_pieces`` of all 30 layers back to back: the pack that
  ``pack_tree`` pays, without the quantization.

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
        print("pack_timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import tree as tree_mod
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.kernels.layout_pack import pack_pieces
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec

    src = pathlib.Path(repro_torch.__file__).resolve().parents[1]
    if src != pathlib.Path(args.src).resolve():
        raise RuntimeError(f"imported repro_torch from {src}, not {args.src}")
    card = cs.card_line()
    print(f"card: {card}; timing {args.label} ({src})")
    dev = torch.device("cuda")
    cfg = SMOLLM_135M
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    out = {"label": args.label, "card": card}

    def record(name, fn, iters):
        ms = cs.time_ms(fn, iters=iters, warmup=1)
        dms, events = cs.device_call(fn, iters=iters)
        out[name] = {"ms": ms, "device_ms": dms, "device_events": events}
        print(f"{name}: {ms:.4f} ms back to back, device {cs.fmt_ms(dms)} "
              f"ms over {events} device events a call")

    for bits in (3, 4):
        spec = QuantSpec(bits=bits, group_size=32)
        handed = []
        real = tree_mod.pack_pieces

        def keep(prog, streams, real=real, handed=handed):
            handed.append((prog, list(streams)))
            return real(prog, streams)

        tree_mod.pack_pieces = keep
        try:
            tree = tree_mod.pack_tree(cfg, params, spec, device=dev)
        finally:
            tree_mod.pack_pieces = real
        torch.cuda.synchronize()
        prog, layer0 = handed[0]
        if not torch.equal(pack_pieces(prog, layer0), tree.streams[0]):
            raise AssertionError(f"int{bits}: pack_pieces of layer 0 != the "
                                 "tree's stream")
        record(f"pack_pieces int{bits} layer",
               lambda p=prog, s=layer0: pack_pieces(p, s), 30)
        record(f"pack_pieces int{bits} x{len(handed)} layers",
               lambda h=handed: [pack_pieces(p, s) for p, s in h], 5)
        record(f"pack_tree int{bits}",
               lambda spec=spec: tree_mod.pack_tree(cfg, params, spec,
                                                    device=dev), 2)
        del tree, handed
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
