#!/usr/bin/env python3
"""Time serving through the stream uploader against resident streams.

    python3 tools/uploader_timing.py [--rounds N]

Packs smollm-135m at full width and depth into int3 streams (seeded
random weights) and serves the 8 prompts of ``chip_smoke.py``'s serve
phase (batch 4, max_seq 256, 16 new tokens each, packed int3 KV) through
``Engine(PackedAdapter(...))`` in turns, ``N`` rounds of
``resident, uploader, side-wait, same-stream`` and back, so that each
way of feeding the layer streams meets the host's drift alike:

* ``resident``: the tree's own streams on the card, no uploads;
* ``uploader``: :class:`repro_torch.engine.StreamUploader` (a side
  stream; the buffer allocated there, recorded on the consuming stream
  with ``record_stream``);
* ``side-wait``: the same side-stream copies into buffers allocated on
  the consuming stream, the side stream first waiting for the consuming
  stream (``wait_stream``), no ``record_stream``;
* ``same-stream``: each layer's words copied from the pinned host words
  on the consuming stream itself, just before use (no overlap).

Each serve's ms per step is the host clock over the drained engine, its
tokens must equal the resident serve's.  Prints the card, one line per
serve, the medians and one JSON line.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs              # its card line; puts src on the path
    import torch

    if not torch.cuda.is_available():
        print("uploader_timing: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.engine import (
        Engine,
        EngineConfig,
        EngineRequest,
        PackedAdapter,
        StreamUploader,
    )
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

    class SideWait(StreamUploader):
        """Copies on the side stream into buffers of the consuming
        stream, which the side stream waits for first."""

        def _upload(self, layer):
            words = self.tree.host_stream_words(layer)
            current = torch.cuda.current_stream(self.device)
            buf = torch.empty_like(words, device=self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                buf.copy_(words, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            self.uploads += 1
            self.bytes_uploaded += words.numel() * words.element_size()
            return buf, done

        def __call__(self, layer):
            layer = layer % self.n_layers
            key = (self._sig, layer)
            entry = self.ring.get(key)
            if entry is None:
                self.sync_fetches += 1
                entry = self._upload(layer)
                self.ring.put(key, entry)
            else:
                self.prefetch_hits += 1
            buf, done = entry
            torch.cuda.current_stream(self.device).wait_event(done)
            if self.n_layers > 1:
                self.prefetch(layer + 1)
            return buf

    class SameStream:
        """Each layer's words copied on the consuming stream, just
        before use."""

        def __init__(self, tree):
            self.tree = tree
            self.bytes_uploaded = 0

        def __call__(self, layer):
            words = self.tree.host_stream_words(layer)
            self.bytes_uploaded += words.numel() * words.element_size()
            return words.to(self.tree.device, non_blocking=True)

        def stats(self):
            return {"bytes_uploaded": self.bytes_uploaded}

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    cfg = SMOLLM_135M
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    tree = pack_tree(cfg, params, QuantSpec(bits=3, group_size=32),
                     device=dev)
    del params
    tree.host_stream_words(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(2, 6))).tolist()
               for _ in range(8)]
    sources = {"resident": lambda: None,
               "uploader": lambda: StreamUploader(tree),
               "side-wait": lambda: SideWait(tree),
               "same-stream": lambda: SameStream(tree)}

    def serve(name):
        engine = Engine(PackedAdapter(cfg, tree, kv="packed", kv_bits=3,
                                      uploader=sources[name]()),
                        EngineConfig(batch_size=4, max_seq=256,
                                     max_backlog=None))
        reqs = [EngineRequest(uid=uid, prompt=p, max_new_tokens=16)
                for uid, p in enumerate(prompts)]
        for req in reqs:
            engine.submit(req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = engine.run_until_drained(max_steps=2000)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / stats.steps * 1e3
        if stats.completed != len(prompts):
            raise AssertionError(f"{name}: completed {stats.completed}")
        return ms, [r.generated for r in reqs], \
            engine.metrics.stream_bytes

    serve("resident")                    # warm-up: tables, allocator
    names = list(sources)
    order = [n for _ in range(args.rounds) for n in names + names[::-1]]
    ms = {n: [] for n in names}
    want = None
    for name in order:
        t, tokens, n_bytes = serve(name)
        want = tokens if want is None else want
        if tokens != want:
            raise AssertionError(f"{name}: tokens differ from the first "
                                 "serve's")
        ms[name].append(t)
        print(f"serve {name}: {t:.3f} ms/decode step, {n_bytes} bytes "
              f"uploaded")
    med = {n: float(np.median(v)) for n, v in ms.items()}
    print("medians (ms/decode step): " + ", ".join(
        f"{n} {m:.3f}" for n, m in med.items()))
    print(json.dumps({"card": card, "ms_per_step": ms, "median": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
