#!/usr/bin/env python3
"""Time the weight matmuls B1 and B2 at decode batches and at 64 rows.

    python3 tools/matmul_rows_timing.py [--src DIR] [--label NAME]
        [--data FILE] [--outputs FILE]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so that one run on one card can time an older tree unpacked
elsewhere and this one, in turns.  Only entry points that both have are
called (``stream_matmul``, ``packed_matmul``, a tree's tables and
stream words).

The operands are one layer of smollm-135m, stablelm-3b and qwen2-vl-2b
at full width: for ``stream_matmul`` (B1) the int3 stream and offset
tables of a packed one-layer tree; for ``packed_matmul`` (B2) the
lane-packed int4 codes and bf16 scales of seeded weights at the init
scale K^-0.5.  They
are made once and kept in ``--data`` (default
``build/matmul_rows_timing.pt``), so that every tree timed reads the same
bytes and the trees' lowering is paid once.

Each of the seven matrices is timed at M = 1, 4, 8 and 64, back to back
with CUDA events (host cost included) and on the device (the kernel's
events in a ``torch.profiler`` window), and summed over the layer.  The
outputs at M in (1, 8, 9, 17, 63, 64, 65, 130) go to ``--outputs``, to be
compared bit for bit with another tree's.  Prints the card, one line per
figure, then one JSON line.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_gate",
        "mlp/w_up", "mlp/w_down")
TIMED_M = (1, 4, 8, 64)
SAVED_M = (1, 8, 9, 17, 63, 64, 65, 130)


def make_data(path: pathlib.Path, dev) -> None:
    """The operands of both kernels for smollm-135m, stablelm-3b and
    qwen2-vl-2b."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import QWEN2_VL_2B, SMOLLM_135M, STABLELM_3B
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec, pack_codes_u32, quantize
    from repro_torch.tree import pack_tree

    data = {}
    for name, base in (("smollm", SMOLLM_135M), ("stablelm", STABLELM_3B),
                       ("qwen2_vl", QWEN2_VL_2B)):
        cfg = dataclasses.replace(base, n_layers=1)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        tree = pack_tree(cfg, params, QuantSpec(bits=3, group_size=32),
                         device=dev)
        del params
        rng = np.random.default_rng(len(name))
        stream, packed = {}, {}
        for key in KEYS:
            w_tab, s_tab = tree.device_tables(key)
            stream[key] = (w_tab.cpu(), s_tab.cpu())
            k, n = w_tab.shape
            qt = quantize(torch.from_numpy(
                rng.standard_normal((k, n), np.float32) * k ** -0.5),
                QuantSpec(bits=4, group_size=32))
            packed[key] = (pack_codes_u32(qt.codes, 4), qt.scales)
        data[name] = {"words": tree.layer_stream_words(0).cpu(),
                      "stream": stream, "packed": packed}
        del tree
        torch.cuda.empty_cache()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(data, path)


def time_layers(data: dict, dev, cs, sm, pm) -> tuple[dict, dict]:
    """Each kernel at each model's seven matrices: the timed figures by
    (model, kernel, M), and the outputs at ``SAVED_M`` by name."""
    import numpy as np
    import torch

    out, saved = {}, {}
    for name, d in data.items():
        words = d["words"].to(dev)
        for kernel in ("stream_matmul", "packed_matmul"):
            layer = {m: {"ms": 0.0, "device_ms": 0.0} for m in TIMED_M}
            for key in KEYS:
                if kernel == "stream_matmul":
                    w_tab, s_tab = (t.to(dev) for t in d["stream"][key])

                    def fn(x, w_tab=w_tab, s_tab=s_tab):
                        return sm.stream_matmul(x, words, w_tab, s_tab,
                                                bits=3, group_size=32)
                    k, n = w_tab.shape
                else:
                    pw, sc = (t.to(dev) for t in d["packed"][key])

                    def fn(x, pw=pw, sc=sc):
                        return pm.packed_matmul(x, pw, sc, bits=4,
                                                group_size=32)
                    k, n = sc.shape[0] * 32, sc.shape[1]
                rng = np.random.default_rng(k + n)
                for m in sorted(set(TIMED_M + SAVED_M)):
                    x = torch.from_numpy(rng.standard_normal(
                        (m, k), np.float32)).to(dev)
                    if m in SAVED_M:
                        saved[f"{name} {kernel} {key} M={m}"] = fn(x).cpu()
                    if m not in TIMED_M:
                        continue
                    ms = cs.time_ms(lambda: fn(x))
                    dms = cs.device_ms(lambda: fn(x), f"{kernel}_kernel")
                    layer[m]["ms"] += ms
                    layer[m]["device_ms"] = cs.add_ms(layer[m]["device_ms"],
                                                      dms)
                    print(f"{name} {kernel} {key:11s} K={k:5d} N={n:5d} "
                          f"M={m:2d}: {ms:.4f} ms back to back, device "
                          f"{cs.fmt_ms(dms)} ms")
            for m in TIMED_M:
                out[f"{name} {kernel} M={m}"] = layer[m]
                print(f"{name} {kernel} layer M={m:2d}: {layer[m]['ms']:.4f} "
                      f"ms back to back, device "
                      f"{cs.fmt_ms(layer[m]['device_ms'])} ms")
    return out, saved


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--data", default=str(ROOT / "build" /
                                          "matmul_rows_timing.pt"))
    ap.add_argument("--outputs", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs              # its timers; it puts ROOT/src on
    sys.path.insert(0, args.src)         # the path, --src goes before it
    import torch

    if not torch.cuda.is_available():
        print("matmul_rows_timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm

    src = pathlib.Path(repro_torch.__file__).resolve().parents[1]
    if src != pathlib.Path(args.src).resolve():
        raise RuntimeError(f"imported repro_torch from {src}, not {args.src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}; timing {args.label} ({src})")
    dev = torch.device("cuda")
    path = pathlib.Path(args.data)
    if not path.exists():
        make_data(path, dev)
    data = torch.load(path)
    out, saved = time_layers(data, dev, cs, sm, pm)
    out.update(label=args.label, card=card)
    if args.outputs:
        torch.save(saved, args.outputs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
