#!/usr/bin/env python3
"""On-card smoke check of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card

1. Prints the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. Builds every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time.
3. Packs smollm-135m at full width and depth (30 layers, seeded random
   weights) into int3 Iris streams, then holds ``stream_matmul`` and
   ``stream_attention`` against their plain PyTorch versions on the card
   at the main path's shapes (as in the first slice), each timed back to
   back (CUDA events) and by its device time per launch
   (``torch.profiler``, which leaves out the host's cost of a launch),
   the library yardstick likewise.
   ``stream_attention`` also at smollm's published context, smax 2048,
   with ``pos`` at 2047, at a split edge and one past it, and at 0; and at
   mistral-large-123b's attention (96 query heads over 8 KV heads, 12 a
   KV head, head_dim 128; B=4) at smax 256 and 2048, beside SDPA.
4. Front door at full width: ``repro_torch.api.plan`` of one smollm layer
   as 14 element arrays (int3 codes and bf16 scale patterns of the 7
   matrices, taken from layer 0 of the int3 tree), C_max 3025.  The
   ``cuda`` pack is byte-equal to the ``numpy`` pack; the ``cuda`` fused
   and per-slot decodes equal the ``numpy`` decode and the input codes,
   one launch each (the per-slot one covers the plan's 2170 units).
   Then ``compare(PAPER_EXAMPLE)`` (C_max 19/13/13/9) and ``cuda`` round
   trips of ``PAPER_EXAMPLE`` and ``INV_HELMHOLTZ`` (three 64-bit arrays,
   two u32 fields a piece), every array through the kernels, launches
   pack / fused / per-slot (1, 1, 1).
5. int4 pack on the card: ``pack_tree`` at full width and depth packs
   each layer with one ``pack_layout_fused`` launch (``pack_pieces``, as
   the int3 pack of step 3 does: 60 launches in all); 30/30 layer streams
   byte-equal to the host ``pack_compiled`` of the quantized pieces.
6. Whole-stack restore: ``unpack_streams`` of the int3 and the int4 tree
   (one ``decode_layout_fused`` launch per layer) rebuilds scales (and
   the int4 views) equal to the tree's; each layer's decode equals the
   host ``unpack_indexed``, the quantized codes and the scale patterns.
   Prints the restore's wall ms and its device ms (every device event of
   a profiler window over the call).
7. Each new kernel against its plain version at the main path's shapes:
   ``packed_matmul`` (the 7 int4 matrices of a layer at M=4, the served
   batch),
   ``pack_layout_fused`` (the whole ``pack_pieces`` call on one int3 and
   one int4 layer, with the pieces as ``pack_tree`` handed them over: one
   kernel in its profiler window, held against ``pack_runs_plain``,
   ``pack_words`` and the layer's stream; beside it ``pack_words``, the
   TPU kernel's form, held against its plain version), ``decode_layout_fused`` (the
   whole call on one int3 and one int4 layer: one kernel in its profiler
   window; beside it ``decode_grid``, the TPU kernel's grid, held against
   ``decode_grid_plain``) and
   ``decode_slot`` (the front door's whole per-slot decode, one launch
   over 2170 units, and a sample of one-unit ``decode_slot`` calls).  Prints
   max errors and times: the kernel back to back and its device time per
   launch, its plain version, one PyTorch library call of the same
   function where there is one (never used by the port, its device time
   beside it), and the least time the card could take (bytes over
   3.35 TB/s or FLOPs over the peak of the unit the kernel runs them on:
   67 TFLOP/s f32 CUDA cores, 989 TFLOP/s bf16 tensor cores).  Tables
   that all layers of a stack share are counted once per stack (spread
   over the layers); the cold figure (tables read on every call) is
   printed beside it.
8. Serves int4 and int3: 8 teacher-forced ragged decode steps through the
   kernels, each against the same step through the plain versions over
   the KV pages the kernels' step wrote (and, for int4, against the
   stream-direct weights on the same state, bit for bit), then ``Engine``
   with ``PackedAdapter(kv="packed")``, batch 4, max_seq 256, 8 requests
   of 16 new tokens.  Launch counters are zeroed just before each path
   and read just after: int4 serving launches ``packed_matmul`` 7 x 30
   times per step and ``stream_matmul`` never; int3 the reverse.
   After the int3 serve, the checkpoint phase
   (:func:`checkpoint_phase`): an int3 ``PackedKVCache`` (batch 4,
   max_seq 256) after 8 teacher-forced ragged decode steps is saved with
   the int3 tree (``CheckpointManager.save_packed(..., kv=...)``: bytes
   and wall s), verified on the host (``verify_packed``: ``ok``, with the
   ``kvcache`` pass; wall s) and restored on the card (``restore_packed``:
   30 ``decode_layout_fused`` launches, counted; streams, scales and
   unquantized leaves equal to the tree's, bit for bit; wall ms and the
   device ms of a profiler window over the call, split into memory
   copies and the rest, beside ``unpack_streams`` of the resident tree;
   ``restore_kv``: pages equal, provenance ``"checkpoint"``).  4 more
   decode steps from the original state and from the restored tree and
   cache give bit-equal logits.  The int4 tree is saved and restored
   without KV (views equal) and 2 decode steps through ``packed_matmul``
   from each, on fresh int4 caches, are bit-equal.  A flipped stream
   bit and a truncated stream on disk are refused with ``AnalysisError``
   under ``manifest/stream-digest`` and ``manifest/stream-shape``.  The
   restored int3 tree then serves the 8 prompts through a
   ``StreamUploader`` (``completed=8/8``, tokens equal to the resident
   serve's, 210 ``stream_matmul`` and 30 ``stream_attention`` launches a
   step, one sync fetch) three times, in turns with three serves from
   its resident streams; a profiled window of 4 steps through the
   uploader; and the 30 layers' uploads on the side stream, timed with
   CUDA events against the bytes over 64 GB/s (PCIe Gen5 x16, one
   direction, by the data sheet).
   Then a ``torch.profiler`` window over 4 steady engine steps of each,
   int3 and int4.
9. Frees the smollm trees, then jamba-1.5-large-398b at its full widths,
   cut to one period (``n_layers`` 72 -> 8: 7 Mamba sublayers and 1 GQA
   attention sublayer) and ``moe=None`` (every sublayer takes the dense
   MLP of d_ff 24576; the MoE sublayers would not fit one card beside the
   rest): 10.77 B seeded random bf16 parameters, 21.5 GB.
   ``ssd_scan`` against its plain version on the layer-0 Mamba inputs of
   the real prefill (bf16, B=2, T=1024, H=256, dk=dv=64), on a ragged
   f32 case (T=1000, ``state0``, final state) and at Mamba-2's d_state
   128 (dk=128, dv=64, bf16, seeded inputs); ``build_prefill_step`` at
   B=2, T=1024 (7 ``ssd_scan`` launches, counted); teacher-forced decode
   of 2 prompts of 16 tokens through ``build_serve_step`` against the
   prefill's logits, in bf16 (stated tolerance) and, with the same
   weights widened to f32, at the reference's 1e-3 with greedy argmax
   equal at every position; ``Engine(DenseAdapter)`` with 8 requests,
   batch 4, max_seq 256, 8 new tokens each, against the decode step's
   bytes bound.  Peak device memory is printed for each jamba phase.
10. Prints one JSON ``checkpoint`` line (the checkpoint phase's
    figures) and one JSON ``kernels`` line (seven kernels, each with its
    ``device_ms``; the matmuls and ``stream_attention`` also with
    ``library_device_ms``; ``stream_attention`` with its smax-2048 and
    rep-12 points, ``ssd_scan`` with its dk=128 point),
    the card line again, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  Without a CUDA device it exits 2; run alone, outside the
repository, it cannot import the port and fails.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM data-sheet peaks (NVIDIA: 3.35 TB/s HBM3, 67 TFLOP/s f32 on
#: CUDA cores, 989 TFLOP/s bf16 on tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
#: PCIe Gen5 x16, one direction, by the data sheet: the host->device
#: upload's bound
PCIE_BYTES_PER_S = 64e9

MM_KEYS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
           "mlp/w_gate", "mlp/w_up", "mlp/w_down")
#: stream_matmul: kernel vs plain (f32 sums in another order)
MM_RTOL, MM_ATOL = 1e-4, 1e-4
#: stream_attention: kernel vs plain.  bf16 output of f32 sums taken in
#: another order: one bf16 ulp of the element (2^-7 relative at most),
#: plus a floor for elements near 0
ATT_RTOL, ATT_ATOL = 2.0 ** -7, 1e-4
#: decode logits, kernels vs plain versions: bf16 logits after 30 layers
#: of bf16 residual adds; in bf16 ulps of the largest logit
LOGIT_ULPS = 4
DECODE_STEPS = 8
#: rows of a decode step's matmuls: the serve phases' batch
SERVE_M = 4
#: the front door's layer problem plans to this C_max (by d_model; the
#: reference planner gives the same), B_eff 0.9997 at full width
FRONT_DOOR_C_MAX = {576: 3025}
#: ssd_scan kernel vs plain: f32 inputs, f32 sums in another order (the
#: reference's own chunked-vs-recurrent bound); bf16 output, one bf16 ulp
#: of the element plus a floor for elements near 0
SCAN_F32_TOL = dict(rtol=2e-4, atol=2e-4)
SCAN_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
#: jamba decode vs prefill logits.  bf16: |logit| <= ~5 in bf16 (one ulp
#: is 2^-5 at 4); eight sublayers of bf16 rounding move the two paths
#: apart by 0.227-0.291 at the reduced width and 0.242 / 0.203 at d_model
#: 1024 / 2048 in CPU rehearsals (the reference's own two paths: 0.219 at
#: the reduced width), so 0.5; top-2 margins below one ulp are common
#: among 65536 bf16 logits, so greedy agreement is required in f32.  f32
#: (the same weights widened): the reference's own bound, 1e-3.
DECODE_BF16_ATOL = 0.5
DECODE_F32_TOL = dict(rtol=1e-3, atol=1e-3)
#: jamba prefill shape (the ssd_scan kernel line is timed here)
PREFILL_B, PREFILL_T = 2, 1024


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean ms per call, CUDA events around ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_window(fn, kernel: str | None, iters: int
                   ) -> tuple[float, int, set[str], float] | None:
    """``torch.profiler`` over ``iters`` back-to-back calls of ``fn``
    after a warm-up step of as many: the device time (us), the count and
    the names of the device events whose name contains ``kernel`` (every
    device event when None), and the device time (us) of the memory
    copies (``Memcpy``) among them.  A window in which the profiler
    recorded no device time is taken again once; None if it stays
    empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(2):
        # the active step's events, taken before the profiler clears them
        ready = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: ready.append(p.key_averages())
                     ) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in ready[0]
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (kernel is None or kernel in e.key)]
        key = "self_device_time_total" if events and hasattr(
            events[0], "self_device_time_total") else "self_cuda_time_total"
        total = sum(getattr(e, key) for e in events)
        if total > 0:
            return (total, sum(e.count for e in events),
                    {e.key for e in events},
                    sum(getattr(e, key) for e in events
                        if "Memcpy" in e.key))
        print(f"device_ms: the profiler recorded no device time of "
              f"{kernel or 'the call'}; once more")
    return None


def device_ms(fn, kernel: str | None, iters: int = 30,
              per_call: int = 1) -> float | None:
    """Device time per call of the CUDA kernel whose name contains
    ``kernel`` (of every kernel ``fn`` launches when ``kernel`` is None):
    ``torch.profiler``'s device time over ``iters`` back-to-back calls,
    divided by the launches it recorded over ``per_call``, the launches
    of one call (by ``iters`` for None).  Unlike :func:`time_ms` it
    leaves out the host's cost of each launch.  None where the profiler
    recorded no device time (printed, never 0)."""
    window = _device_window(fn, kernel, iters)
    if window is None:
        return None
    total, n = window[:2]
    if kernel is None:
        n = iters * per_call
    elif n != iters * per_call:
        print(f"device_ms: the profiler recorded {n} of {iters * per_call} "
              f"launches of {kernel}")
    return total / (n / per_call) / 1e3


def device_call(fn, iters: int = 30) -> tuple[float | None, float | None]:
    """Device time (ms) of one call of ``fn``, summed over every device
    event of the profiler window, and the device events (kernels and
    copies) per call."""
    window = _device_window(fn, None, iters)
    if window is None:
        return None, None
    return window[0] / iters / 1e3, window[1] / iters


def one_kernel_ms(fn, kernel: str, what: str, iters: int = 30
                  ) -> float | None:
    """Device time (ms) of one call of ``fn``, which must run on the
    device the one kernel whose name contains ``kernel`` and nothing
    else: every device event of the profiler window is that kernel, at
    most one a call.  The profiler may drop a few activity records from a
    window (28 of 30 calls' kernels seen on an H100), so the time is the
    mean of the launches it kept; the caller's launch counter checks that
    each call launches once."""
    window = _device_window(fn, None, iters)
    if window is None:
        return None
    total, n, names = window[:3]
    if n > iters or any(kernel not in k for k in names):
        raise AssertionError(f"{what}: {n} device events over {iters} calls "
                             f"({sorted(names)}), expected one {kernel} a "
                             "call and nothing else")
    if n != iters:
        print(f"{what}: the profiler recorded {n} of {iters} launches")
    return total / n / 1e3


def fmt_ms(ms: float | None) -> str:
    return "not recorded" if ms is None else f"{ms:.4f}"


def add_ms(a: float | None, b: float | None) -> float | None:
    return None if a is None or b is None else a + b


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def check_stream_matmul(tree, rng, dev) -> dict:
    """Each of the 7 matrices at M in {1, 4, 8} plus one ragged shape;
    timed at M=4, the served batch.  The bound counts the offset tables
    once per decode step, over the tree's layers, as the main path and
    the timed repeats read them."""
    import torch

    from repro_torch.core.exec_plan import (
        lower_exec,
        pack_compiled,
        stream_matmul_tables,
    )
    from repro_torch.core.iris import schedule
    from repro_torch.core.util import pad_bundle_elements
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.kernels.ref import table_tensor, words_tensor
    from repro_torch.plan import BundleTensor, bundle_problem
    from repro_torch.quant import QuantSpec, bits16, quantize

    words = tree.layer_stream_words(0)
    bits, g = tree.spec.bits, tree.spec.group_size
    n_layers = tree.n_layers
    max_err = 0.0
    layer = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0, "library_device_ms": 0.0, "bytes": 0,
             "table_bytes": 0, "flops": 0}
    for key in MM_KEYS:
        w_tab, s_tab = tree.device_tables(key)
        k, n = w_tab.shape
        for m in (1, 4, 8):
            x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
            got = sm.stream_matmul(x, words, w_tab, s_tab, bits=bits,
                                   group_size=g)
            want = sm.stream_matmul_plain(x, words, w_tab, s_tab, bits=bits,
                                          group_size=g)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            if not torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL):
                raise AssertionError(
                    f"stream_matmul {key} M={m}: max |err| {err:.3g}")
            if m != SERVE_M:
                continue
            dense = sm.stream_matmul_plain(
                torch.eye(k, device=dev), words, w_tab, s_tab, bits=bits,
                group_size=g)
            ms = time_ms(lambda: sm.stream_matmul(
                x, words, w_tab, s_tab, bits=bits, group_size=g))
            dms = device_ms(lambda: sm.stream_matmul(
                x, words, w_tab, s_tab, bits=bits, group_size=g),
                "stream_matmul_kernel")
            pms = time_ms(lambda: sm.stream_matmul_plain(
                x, words, w_tab, s_tab, bits=bits, group_size=g), iters=5)
            lms = time_ms(lambda: torch.matmul(x, dense))
            ldms = device_ms(lambda: torch.matmul(x, dense), None)
            # the tables serve every layer: read once per decode step
            tab_bytes = (w_tab.numel() + s_tab.numel()) * 4
            nbytes = (x.numel() * 4 + -(-k * n * bits // 8)
                      + s_tab.numel() * 2 + m * n * 4)
            flops = 2 * m * k * n
            bms, _ = bound_ms(nbytes + tab_bytes / n_layers, flops)
            print(f"stream_matmul {key:11s} K={k:5d} N={n:5d} M={m}: "
                  f"kernel {ms:.4f} ms (device {fmt_ms(dms)} ms, grid "
                  f"{sm.matmul_launch(m, k, n)[1]})  plain {pms:.4f} ms  "
                  f"library(matmul of dequantized W) {lms:.4f} ms (device "
                  f"{fmt_ms(ldms)} ms)  bound {bms:.5f} ms  max|err| "
                  f"{err:.3g}")
            layer["ms"] += ms
            layer["device_ms"] = add_ms(layer["device_ms"], dms)
            layer["library_device_ms"] = add_ms(
                layer["library_device_ms"], ldms)
            layer["plain_ms"] += pms
            layer["library_ms"] += lms
            layer["bytes"] += nbytes
            layer["table_bytes"] += tab_bytes
            layer["flops"] += flops
    # one ragged shape on its own int5 stream: K, N, M all off the tiles
    k, n, m, gg, rb = 96, 77, 3, 32, 5
    spec = QuantSpec(bits=rb, group_size=gg)
    wr = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(dev)
    qt = quantize(wr, spec)
    bundle = [BundleTensor("w", rb, k * n, 1),
              BundleTensor("w_scales", 16, (k // gg) * n, 1)]
    prob = bundle_problem(bundle, m=512)
    lay = schedule(prob)
    prog = lower_exec(lay, elem_widths=(rb, 16))
    data = {"w": qt.codes.cpu().numpy().reshape(-1),
            "w_scales": bits16(qt.scales).cpu().numpy().reshape(-1)}
    buf = pack_compiled(lay, pad_bundle_elements(prob, prog, data),
                        program=prog)
    tabs = stream_matmul_tables(lay, "w", (k, n), scales="w_scales",
                                group_size=gg, program=prog)
    rw = words_tensor(prog.buffer_words32(buf).reshape(-1), dev)
    rwt, rst = table_tensor(tabs.w_tab, dev), table_tensor(tabs.s_tab, dev)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
    got = sm.stream_matmul(x, rw, rwt, rst, bits=rb, group_size=gg)
    want = sm.stream_matmul_plain(x, rw, rwt, rst, bits=rb, group_size=gg)
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    if not torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL):
        raise AssertionError(f"stream_matmul ragged: max |err| {err:.3g}")
    print(f"stream_matmul ragged int{rb} K={k} N={n} M={m}: "
          f"max|err| {err:.3g}")
    # every layer shares the tables (one layout), which fit the 50 MB L2:
    # a decode step reads them from HBM once, for all its layers
    step_bytes = layer["bytes"] + layer["table_bytes"] / n_layers
    bms, by = bound_ms(step_bytes, layer["flops"])
    cold, cold_by = bound_ms(layer["bytes"] + layer["table_bytes"],
                             layer["flops"])
    print(f"stream_matmul, one layer's 7 matmuls at M={SERVE_M}: kernel "
          f"{layer['ms']:.4f} ms back to back (device "
          f"{fmt_ms(layer['device_ms'])} ms, "
          f"{fmt_ms(layer['device_ms'] and layer['device_ms'] / 7)} ms per "
          f"launch)  plain "
          f"{layer['plain_ms']:.4f} ms  library {layer['library_ms']:.4f} "
          f"ms (device {fmt_ms(layer['library_device_ms'])} ms)  bound "
          f"{bms:.5f} ms "
          f"({by}; {step_bytes:.0f} B with the {layer['table_bytes']} B "
          f"of tables over {n_layers} layers, {layer['flops']} f32 FLOPs); "
          f"cold-L2 bound {cold:.5f} ms ({cold_by}; tables read on every "
          f"call)")
    return {"max_abs_err": max_err, "ms": layer["ms"],
            "device_ms": layer["device_ms"],
            "plain_ms": layer["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": layer["library_ms"],
            "library_device_ms": layer["library_device_ms"]}


def check_stream_attention(cfg, rng, dev, smax: int = 256,
                           pos: list[int] | None = None) -> dict:
    """B=4, H=9, Hkv=3, hd=64, int3, ragged positions (by default
    255/191/127/63 at smax 256, the first slice's shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kvcache import PackedKVCache
    from repro_torch.kvcache import stream_attention as sa

    b, bits = 4, 3
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kvc = PackedKVCache.create(cfg, bits=bits, page_tokens=8, n_slots=b,
                               max_seq=smax, n_layers=1, device=dev)
    slots = torch.arange(b, device=dev)
    for t in range(smax):
        k = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        v = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        kvc.append(k.to(dev), v.to(dev), torch.full((b,), t, device=dev),
                   slots, layer=0)
    pos = torch.tensor(pos or [255, 191, 127, 63], device=dev)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd), np.float32)) \
        .to(dev).to(torch.bfloat16)
    words = kvc.layer_words(0)
    tabs = kvc.device_stream_tables()
    args = (words, slots, q, pos, tabs["k"], tabs["k_scales"], tabs["v"],
            tabs["v_scales"])
    got = sa.stream_attention(*args, bits=bits)
    want = sa.stream_attention_plain(*args, bits=bits)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=ATT_RTOL,
                          atol=ATT_ATOL):
        raise AssertionError(f"stream_attention smax={smax}: max |err| "
                             f"{err:.3g}")
    ms = time_ms(lambda: sa.stream_attention(*args, bits=bits))
    dms = device_ms(lambda: sa.stream_attention(*args, bits=bits),
                    "stream_attention_kernel")
    pms = time_ms(lambda: sa.stream_attention_plain(*args, bits=bits),
                  iters=5)
    kf, vf = kvc.dense_kv(0, slots)
    kd = kf.repeat_interleave(h // hkv, dim=2).transpose(1, 2) \
        .to(torch.bfloat16)
    vd = vf.repeat_interleave(h // hkv, dim=2).transpose(1, 2) \
        .to(torch.bfloat16)
    mask = torch.arange(smax, device=dev)[None, None, None, :] \
        <= pos[:, None, None, None]
    qd = q.transpose(1, 2)
    lms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    ldms = device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask), None)
    n_tok = pos.cpu().numpy().astype(np.int64) + 1
    # the K/V offset tables serve every layer: read once per decode step
    tab_bytes = int(n_tok.max()) * hkv * (hd + 1) * 4 * 2
    nbytes = (q.numel() * 2 + b * 8 + q.numel() * 2
              + int(n_tok.sum()) * hkv * (-(-hd * bits // 8) + 2) * 2)
    flops = int(n_tok.sum()) * h * hd * 4
    bms, by = bound_ms(nbytes + tab_bytes / cfg.n_layers, flops)
    cold, cold_by = bound_ms(nbytes + tab_bytes, flops)
    splits, tpb, smem = sa.attention_launch(b, hkv, h // hkv, hd, smax)
    print(f"stream_attention B={b} smax={smax} H={h} Hkv={hkv} hd={hd} "
          f"int{bits} pos={pos.tolist()} (grid {b}x{hkv}x{splits}, {tpb} "
          f"tokens a block, {smem} B shared): kernel {ms:.4f} ms back to "
          f"back (device {fmt_ms(dms)} ms)  plain {pms:.4f} ms  "
          f"library(sdpa on "
          f"dense_kv) {lms:.4f} ms (device {fmt_ms(ldms)} ms)  bound "
          f"{bms:.6f} ms ({by}; {tab_bytes} B "
          f"of tables over {cfg.n_layers} layers); cold-L2 bound "
          f"{cold:.6f} ms ({cold_by})  max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": lms,
            "library_device_ms": ldms}


def check_long_attention(cfg, rng, dev) -> dict:
    """``stream_attention`` at smollm-135m's published context (2048,
    ``max_position_embeddings`` of ``HuggingFaceTB/SmolLM-135M``), int3,
    B=4, with ``pos`` at 2047, at a split edge (the last token of a
    block), one past it (the first of the next), and at 0."""
    from repro_torch.kvcache import stream_attention as sa

    smax = 2048
    splits, tpb, _ = sa.attention_launch(
        4, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, smax)
    edge = (splits // 2) * tpb - 1
    return check_stream_attention(cfg, rng, dev, smax=smax,
                                  pos=[smax - 1, edge, edge + 1, 0])


def mistral_attention_config():
    """The attention of mistral-large-123b (HF
    ``mistralai/Mistral-Large-Instruct-2407``: 88 layers, d_model 12288,
    96 query heads over 8 KV heads of head_dim 128, so 12 query heads per
    KV head), on smollm's config class: only the attention's widths and
    the layer count (the tables' sharing) are read."""
    import dataclasses

    from repro_torch.configs import SMOLLM_135M

    return dataclasses.replace(SMOLLM_135M, name="mistral-large-123b",
                               n_layers=88, d_model=12288, n_heads=96,
                               n_kv_heads=8, head_dim=128)


def check_rep12_attention(dev) -> dict:
    """``stream_attention`` at 12 query heads per KV head (mistral-large-
    123b's attention, B=4, int3) at smax 256 and 2048, against the plain
    version and timed beside SDPA; at 2048 with ``pos`` at a split edge
    and one past it."""
    from repro_torch.kvcache import stream_attention as sa

    cfg = mistral_attention_config()
    rows = {"smax_256": check_stream_attention(
        cfg, np.random.default_rng(12), dev, smax=256)}
    splits, tpb, _ = sa.attention_launch(
        4, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, 2048)
    edge = (splits // 2) * tpb - 1
    rows["smax_2048"] = check_stream_attention(
        cfg, np.random.default_rng(2049), dev, smax=2048,
        pos=[2047, edge, edge + 1, 0])
    return rows


def decode_check(cfg, tree, rng, dev, kv_bits: int) -> None:
    """``DECODE_STEPS`` teacher-forced decode steps through the kernels.
    Each step is also taken through the plain versions over the packed KV
    pages that the kernels' step wrote (the plain step appends nothing),
    and the two steps' logits must agree within ``LOGIT_ULPS`` bf16 ulps
    of the largest logit.  Slot i joins at step i, so rows, M and
    positions are ragged and attention runs over up to ``DECODE_STEPS``
    cached tokens.  A tree with lane-packed views serves through
    ``packed_matmul``; its step is also taken with the stream-direct
    weights (``stream_matmul``) over the same pages, and the logits must
    be equal bit for bit (the two kernels sum in one order).

    A further run takes the same tokens through the plain versions on a
    cache of its own.  How far it drifts from the kernels' run is
    printed, not checked: a last-bit difference in an f32 sum can move an
    int-N KV code by a whole step, and later steps attend over it."""
    import copy

    import torch

    from repro_torch.engine import PackedAdapter
    from repro_torch.models.quantized import packed_decode_step

    def read_only(state, pos):
        # layer l's step appends before it attends, and reads no later
        # layer, so the pages after the kernels' step serve it unchanged
        kvc = copy.copy(state["packed_kv"])
        kvc.append = lambda *args, **kwargs: None
        return {"pos": pos, "packed_kv": kvc}

    b = 4
    adapter = PackedAdapter(cfg, tree, kv="packed", kv_bits=kv_bits)
    toks = rng.integers(1, cfg.vocab_size, (DECODE_STEPS, b))
    state = adapter.init_state(b, 256)
    free = adapter.init_state(b, 256)
    ulps, drift, top, worst, bad, unequal = [], 0.0, 0, 0.0, [], []
    for t in range(DECODE_STEPS):
        active = [i for i in range(b) if t >= i]
        slots = torch.tensor(active, device=dev)
        tok = torch.as_tensor(toks[t, active], device=dev)
        pos = state["pos"]
        got, state = packed_decode_step(cfg, tree, state, tok,
                                        slot_ids=slots, kv="packed")
        want, _ = packed_decode_step(cfg, tree, read_only(state, pos), tok,
                                     slot_ids=slots, kv="packed", plain=True)
        if tree.packed:
            streamed, _ = packed_decode_step(
                cfg, tree, read_only(state, pos), tok, slot_ids=slots,
                kv="packed", weights="stream")
            if not torch.equal(got, streamed):
                unequal.append(t)
        alone, free = packed_decode_step(cfg, tree, free, tok,
                                         slot_ids=slots, kv="packed",
                                         plain=True)
        got, want = got.float(), want.float()
        if got.shape != (len(active), cfg.vocab_size) \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"step {t}: logits malformed {got.shape}")
        largest = float(want.abs().max())
        ulp = 2.0 ** (np.floor(np.log2(largest)) - 7)
        err = float((got - want).abs().max())
        ulps.append(float(err / ulp))
        if err > LOGIT_ULPS * ulp:
            bad.append(t)
        drift = max(drift, float((got - alone.float()).abs().max()))
        top += int((got.argmax(-1) == want.argmax(-1)).sum())
        worst = max(worst, largest)
    n_rows = sum(min(t + 1, b) for t in range(DECODE_STEPS))
    pages, free_pages = state["packed_kv"].pages, free["packed_kv"].pages
    name = f"int{tree.spec.bits} weights, int{kv_bits} KV"
    print(f"decode ({name}), {DECODE_STEPS} ragged steps, kernels vs plain "
          f"versions over the same KV pages: max|dlogit| per step in bf16 "
          f"ulps of its largest logit {[round(u, 3) for u in ulps]} "
          f"(tolerance {LOGIT_ULPS}; largest logit {worst:.4g}); same "
          f"top-1 in {top}/{n_rows} rows")
    if tree.packed:
        print(f"decode ({name}): weights='packed' (packed_matmul) vs "
              f"weights='stream' (stream_matmul) over the same pages: "
              f"{DECODE_STEPS - len(unequal)}/{DECODE_STEPS} steps "
              f"bit-equal")
    print(f"decode ({name}), plain versions on a cache of their own: "
          f"max|dlogit| {drift:.4g} from the kernels' run; "
          f"{int((pages != free_pages).sum())} of {pages.numel()} KV page "
          f"words differ")
    if bad:
        raise AssertionError(f"decode steps {bad}: logits beyond "
                             f"{LOGIT_ULPS} bf16 ulps of the plain run")
    if unequal:
        raise AssertionError(f"decode steps {unequal}: packed and stream "
                             f"weights differ")


def serve(cfg, tree, prompts, kv_bits: int, per_step: dict,
          uploader=None, label: str = "") -> tuple[dict, list, float]:
    """A main path: Engine over PackedAdapter(kv='packed'), counted.
    ``per_step`` is each kernel's launches per engine step; ``uploader``
    (a ``StreamUploader``) serves the layer streams through it; ``label``
    follows the line's name.  Returns the launches, each request's
    greedy tokens and the ms per step."""
    import torch

    from repro_torch.engine import (
        Engine,
        EngineConfig,
        EngineRequest,
        PackedAdapter,
    )
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.kvcache import stream_attention as sa

    engine = Engine(PackedAdapter(cfg, tree, kv="packed", kv_bits=kv_bits,
                                  weights="auto", uploader=uploader),
                    EngineConfig(batch_size=4, max_seq=256,
                                 max_backlog=None))
    requests = [EngineRequest(uid=uid, prompt=prompt, max_new_tokens=16)
                for uid, prompt in enumerate(prompts)]
    for req in requests:
        engine.submit(req)
    torch.cuda.synchronize()
    sm.launches = 0
    sa.launches = 0
    pm.launches = 0
    t0 = time.perf_counter()
    stats = engine.run_until_drained(max_steps=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"stream_matmul": sm.launches, "stream_attention": sa.launches,
              "packed_matmul": pm.launches}
    print(f"serve int{tree.spec.bits} weights / int{kv_bits} KV{label}: "
          f"completed={stats.completed}/{len(prompts)} "
          f"steps={stats.steps} tokens={stats.tokens_generated} "
          f"wall={wall:.3f} s tokens/s={stats.tokens_generated / wall:.2f} "
          f"ms/decode step={wall / max(1, stats.steps) * 1e3:.3f} "
          f"launches={counts}")
    if stats.completed != len(prompts):
        raise AssertionError(f"completed {stats.completed}/{len(prompts)}")
    for name, n in counts.items():
        if n != per_step.get(name, 0) * stats.steps:
            raise AssertionError(
                f"{name}: {n} launches in {stats.steps} steps, expected "
                f"{per_step.get(name, 0)} per step")
    for req in requests:
        if len(req.generated) != 16 or not all(
                0 <= t < cfg.vocab_size for t in req.generated):
            raise AssertionError(f"request {req.uid}: bad tokens "
                                 f"{req.generated}")
    return (counts, [req.generated for req in requests],
            wall / max(1, stats.steps) * 1e3)


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (bf16 compared as its int16 bits)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def same_leaves(got, want) -> bool:
    """Two trees of dicts and tensors equal key for key, bit for bit."""
    if isinstance(want, dict):
        return sorted(got) == sorted(want) and all(
            same_leaves(got[k], v) for k, v in want.items())
    return same_bits(got, want)


def same_tree(got, tree) -> bool:
    """A restored tree's streams, scales, views and unquantized leaves
    equal the saved tree's, bit for bit."""
    return all(same_leaves(getattr(got, k), getattr(tree, k))
               for k in ("streams", "scales", "packed", "other"))


def counted_restore(mgr, step: int, dev):
    """``restore_packed`` with the decode launches counted from 0 just
    before it and read just after: (tree, launches, wall ms)."""
    import torch

    from repro_torch.kernels import layout_decode as ld

    torch.cuda.synchronize()
    ld.fused_launches = 0
    t0 = time.perf_counter()
    got, _ = mgr.restore_packed(step, device=dev)
    torch.cuda.synchronize()
    return got, ld.fused_launches, (time.perf_counter() - t0) * 1e3


def device_parts(fn, iters: int = 1
                 ) -> tuple[float | None, float | None, float | None]:
    """Device time (ms) of one call of ``fn`` from one profiler window:
    every device event, the memory copies among them, and the device
    events a call.  Nones where the profiler recorded no device time."""
    window = _device_window(fn, None, iters)
    if window is None:
        return None, None, None
    total, n, _, copies = window
    return total / iters / 1e3, copies / iters / 1e3, n / iters


def decode_steps(cfg, tree, state, toks, ragged: bool = False
                 ) -> tuple[list, dict]:
    """Teacher-forced packed-KV decode steps through the kernels, one a
    row of ``toks`` (``ragged``: slot i joins at step i, as in
    :func:`decode_check`): the logits of each step and the state after
    the last."""
    import torch

    from repro_torch.models.quantized import packed_decode_step

    out = []
    for t, row in enumerate(toks):
        active = [i for i in range(len(row)) if t >= i or not ragged]
        logits, state = packed_decode_step(
            cfg, tree, state, torch.as_tensor(row[active], device=tree.device),
            slot_ids=torch.tensor(active, device=tree.device), kv="packed")
        out.append(logits)
    return out, state


def refused(mgr, step: int, rule: str, dev) -> str:
    """``restore_packed`` of a corrupted checkpoint must raise
    ``AnalysisError`` naming ``rule``: the refusal, rendered."""
    from repro_torch.analysis import AnalysisError

    try:
        mgr.restore_packed(step, device=dev)
    except AnalysisError as e:
        if rule not in e.report.rule_ids():
            raise AssertionError(f"refused, but not under {rule}: {e}") \
                from None
        return next(f.render() for f in e.report.errors if f.rule_id == rule)
    raise AssertionError(f"a checkpoint that breaks {rule} was restored")


def checkpoint_phase(cfg, tree3, tree4, prompts, dev, resident) -> dict:
    """Save -> verify -> restore on the card -> decode on and serve.

    A packed int3 KV cache (batch 4, max_seq 256) after 8 teacher-forced
    ragged steps through the kernels is saved with the int3 tree
    (``save_packed(..., kv=...)``), verified (``verify_packed``: ``ok``,
    with the ``kvcache`` pass) and restored on the card
    (``restore_packed``: 30 ``decode_layout_fused`` launches; streams,
    scales and unquantized leaves equal to the tree's; ``restore_kv``:
    pages equal, provenance ``"checkpoint"``).  4 more decode steps from
    the original state and from the restored tree and cache give equal
    logits, bit for bit.  The int4 tree is saved and restored without KV
    (views equal) and 2 steps through ``packed_matmul`` from each, on
    fresh int4 caches, are equal bit for bit.  A flipped stream bit and
    a truncated stream on disk are refused under
    ``manifest/stream-digest`` and ``manifest/stream-shape``.  Last the
    restored int3 tree serves the serve phase's 8 prompts through a
    ``StreamUploader`` (tokens equal to the resident serve's ``resident``
    tokens, 210 + 30 launches a step), three times in turns with three
    serves from its resident streams, then a profiled window of 4 steps
    through the uploader; and the 30 layers' uploads, back
    to back on the uploader's side stream, are timed against their PCIe
    bound.  Returns the figures."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import (
        Engine,
        EngineConfig,
        PackedAdapter,
        StreamUploader,
    )
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.tree import unpack_streams

    rng = np.random.default_rng(20)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="iris-ckpt-"))
    try:
        mgr = CheckpointManager(tmp, keep_n=0)
        b = 4
        adapter = PackedAdapter(cfg, tree3, kv="packed", kv_bits=3)
        state = adapter.init_state(b, 256)
        toks = rng.integers(1, cfg.vocab_size, (DECODE_STEPS + 4, b))
        _, state = decode_steps(cfg, tree3, state, toks[:DECODE_STEPS],
                                ragged=True)
        cache = state["packed_kv"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = pathlib.Path(mgr.save_packed(1, tree3, {"decode_steps":
                                                       DECODE_STEPS},
                                            kv=cache))
        save_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in path.iterdir())
        print(f"checkpoint save: int3 tree + int3 KV cache (batch {b}, "
              f"max_seq 256, after {DECODE_STEPS} ragged decode steps): "
              f"{n_bytes} bytes in {len(list(path.iterdir()))} files, "
              f"{save_s:.3f} s wall")
        t0 = time.perf_counter()
        report = mgr.verify_packed(1)
        verify_s = time.perf_counter() - t0
        print(f"checkpoint verify: ok={report.ok} passes={report.passes} "
              f"errors={len(report.errors)} warnings={len(report.warnings)}"
              f"; {verify_s:.3f} s wall")
        if not report.ok or "kvcache" not in report.passes:
            raise AssertionError(report.render())

        restored3, launches3, wall3 = counted_restore(mgr, 1, dev)
        equal3 = same_tree(restored3, tree3)
        dms, cms, events = device_parts(
            lambda: mgr.restore_packed(1, device=dev))
        ums, _ = device_call(
            lambda: unpack_streams(tree3.manifest, tree3.streams,
                                   tree3.other, device=dev), iters=2)
        rest_ms = None if dms is None else dms - cms
        print(f"checkpoint restore int3: restore_packed ({restored3.provenance}"
              f") {wall3:.1f} ms wall, device {fmt_ms(dms)} ms over "
              f"{events} device events, of which memory copies "
              f"{fmt_ms(cms)} ms and the rest {fmt_ms(rest_ms)} ms "
              f"(unpack_streams of the resident tree {fmt_ms(ums)} ms); "
              f"{launches3} decode_layout_fused launches; streams, scales "
              f"and unquantized leaves equal to the saved tree's: {equal3}")
        if launches3 != tree3.n_layers or not equal3:
            raise AssertionError("restore int3 differs from the saved tree")
        kv = mgr.restore_kv(1, device=dev)
        provenance = kv.provenance
        pages_equal = torch.equal(kv.pages, cache.pages)
        print(f"checkpoint restore_kv: provenance={provenance} pages "
              f"{tuple(kv.pages.shape)} equal to the cache's: {pages_equal}")
        if provenance != "checkpoint" or not pages_equal:
            raise AssertionError("restore_kv differs from the cache")

        rest = {"pos": state["pos"].clone(), "packed_kv": kv}
        want, state = decode_steps(cfg, tree3, state, toks[DECODE_STEPS:])
        got, rest = decode_steps(cfg, restored3, rest, toks[DECODE_STEPS:])
        on3 = sum(torch.equal(g, w) for g, w in zip(got, want))
        print(f"checkpoint decode on: {on3}/{len(want)} steps from the "
              f"restored tree and cache bit-equal to the original's")
        if on3 != len(want):
            raise AssertionError("decode after restore differs")

        mgr.save_packed(2, tree4)
        restored4, launches4, wall4 = counted_restore(mgr, 2, dev)
        equal4 = same_tree(restored4, tree4)
        views4 = sorted(restored4.packed) == sorted(tree4.packed) and all(
            torch.equal(restored4.packed[k], v)
            for k, v in tree4.packed.items())
        logits4 = []
        pm.launches = 0
        for t4 in (tree4, restored4):
            ad4 = PackedAdapter(cfg, t4, kv="packed", kv_bits=4)
            out, _ = decode_steps(cfg, t4, ad4.init_state(b, 256), toks[:2])
            logits4.append(out)
        on4 = sum(torch.equal(g, w) for g, w in zip(*logits4))
        print(f"checkpoint restore int4 (no KV): {wall4:.1f} ms wall, "
              f"{launches4} decode_layout_fused launches; tree equal "
              f"{equal4}, lane-packed views equal {views4}; 2 decode steps "
              f"through packed_matmul ({pm.launches} launches) from the "
              f"restored and the original tree: {on4}/2 bit-equal")
        if launches4 != tree4.n_layers or not (equal4 and views4) \
                or on4 != 2 or pm.launches != 2 * 2 * 7 * cfg.n_layers:
            raise AssertionError("restore int4 differs from the tree")
        del restored4

        meta = json.loads((path / "manifest.json").read_text())
        stream_file = f"arr_{meta['paths'].index('streams'):05d}.npy"
        refusals = {}
        for step, rule in ((3, "manifest/stream-digest"),
                           (4, "manifest/stream-shape")):
            bad = tmp / f"step_{step:08d}"
            shutil.copytree(path, bad)
            arr = np.load(bad / stream_file)
            if step == 3:
                arr.flat[12345] ^= np.uint8(0x10)
            else:
                arr = arr[:, :-1]
            np.save(bad / stream_file, arr)
            refusals[rule] = refused(mgr, step, rule, dev)
            what = "a flipped bit" if step == 3 else "a truncated stream"
            print(f"checkpoint refused ({what}): {refusals[rule]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the restored tree served through an uploader and from its resident
    # streams in turns (U R R U U R): one serve's ms per step moves with
    # the host's load by more than the uploader's cost
    per_step = {"stream_attention": cfg.n_layers,
                "stream_matmul": 7 * cfg.n_layers}
    ms_up, ms_res, stats, tokens_equal = [], [], [], True
    for through in (True, False, False, True, True, False):
        up = StreamUploader(restored3) if through else None
        counts, tokens, ms = serve(
            cfg, restored3, prompts, 3, per_step, uploader=up,
            label=" (restored tree, through the StreamUploader)" if through
            else " (restored tree, resident streams)")
        tokens_equal = tokens_equal and tokens == resident[0]
        if through:
            up.close()
            ms_up.append(ms)
            stats.append(up.stats())
            side = up.stream
        else:
            ms_res.append(ms)
    profile_steps(Engine(PackedAdapter(cfg, restored3, kv="packed",
                                       kv_bits=3,
                                       uploader=StreamUploader(restored3)),
                         EngineConfig(batch_size=4, max_seq=256,
                                      max_backlog=None)),
                  prompts, "int3 weights / int3 KV, restored, through the "
                  "StreamUploader")
    # the uploader's copies, one a layer from its pinned words, back to
    # back on its side stream into buffers allocated beforehand: the host
    # enqueues a copy faster than the card runs it, so the events time
    # the copies and not the host
    words = [restored3.host_stream_words(la)
             for la in range(restored3.n_layers)]
    bufs = [torch.empty_like(w, device=dev) for w in words]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        start.record(side)
        for buf, w in zip(bufs, words):
            buf.copy_(w, non_blocking=True)
        end.record(side)
    torch.cuda.synchronize()
    upload_ms = start.elapsed_time(end) / len(words)
    layer_bytes = words[0].numel() * words[0].element_size()
    bound = layer_bytes / PCIE_BYTES_PER_S * 1e3
    del bufs
    print(f"serve through the StreamUploader: tokens equal to the resident "
          f"int3 serve's: {tokens_equal}; ms/decode step through the "
          f"uploader {[round(x, 3) for x in ms_up]}, median "
          f"{np.median(ms_up):.3f}; from the restored tree's resident "
          f"streams {[round(x, 3) for x in ms_res]}, median "
          f"{np.median(ms_res):.3f} (the original tree's serve "
          f"{resident[1]:.3f}); uploader {stats[0]}; "
          f"{stats[0]['bytes_uploaded'] / max(1, stats[0]['uploads']):.0f} "
          f"bytes an upload; one layer's upload on the side stream "
          f"{upload_ms:.4f} ms, bound {bound:.4f} ms ({layer_bytes} bytes "
          f"at {PCIE_BYTES_PER_S / 1e9:.0f} GB/s, PCIe Gen5 x16 one "
          f"direction by the data sheet)")
    if not tokens_equal or any(st["sync_fetches"] != 1 for st in stats):
        raise AssertionError("uploader serve differs from the resident "
                             f"serve (uploader counters {stats})")
    return {"save_bytes": n_bytes, "save_s": save_s, "verify_s": verify_s,
            "verify_passes": report.passes,
            "restore_int3_wall_ms": wall3, "restore_int3_device_ms": dms,
            "restore_int3_copy_ms": cms, "restore_int3_rest_ms": rest_ms,
            "unpack_int3_device_ms": ums,
            "restore_int3_decode_launches": launches3,
            "restore_int4_wall_ms": wall4,
            "restore_int4_decode_launches": launches4,
            "kv_provenance": provenance, "kv_pages_equal": pages_equal,
            "decode_on_bit_equal": f"{on3}/{len(want)}",
            "int4_decode_bit_equal": f"{on4}/2",
            "refused": sorted(refusals),
            "uploader_serve_launches": counts,
            "uploader_tokens_equal": tokens_equal,
            "uploader_ms_per_step": ms_up,
            "restored_resident_ms_per_step": ms_res,
            "resident_ms_per_step": resident[1],
            "uploader_stats": stats[0], "upload_ms_per_layer": upload_ms,
            "upload_bound_ms": bound}


def layer_mats(cfg) -> dict[str, tuple[int, int]]:
    """(K, N) of each quantized matrix of a layer, by bundle name."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def host_pieces(tree, layer: int) -> dict[str, np.ndarray]:
    """Host unpack of one layer stream: bundle name -> uint64 pieces."""
    prog = tree.exec_program()
    names = [a.name for a in tree.layout().problem.arrays]
    out = prog.unpack_indexed(tree.streams[layer].cpu().numpy())
    return {names[i]: v for i, v in out.items()}


def n_units(dplan) -> int:
    """Units of the per-slot decode of a plan: one per slot, two for a
    slot wider than 32 bits (its low and high u32 fields)."""
    return dplan.n_units + sum(s.width > 32 for s in dplan.slots)


def front_door(cfg, tree3, dev):
    """``api.plan`` of one smollm layer as 14 element arrays (the codes
    and scale patterns of layer 0 of the int3 tree); numpy / cuda pack
    and numpy / cuda fused / cuda per-slot decode must agree with each
    other and with the codes; each decode is one launch.  Then the
    paper's example and the inverse Helmholtz problem.  Returns the plan,
    its packed buffer and the per-slot path's launches."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels import layout_pack as lp

    g = tree3.spec.group_size
    mats = layer_mats(cfg)
    specs = []
    for name, (k, n) in mats.items():
        specs += [(name, 3, k * n, 0), (f"{name}_scales", 16, k * n // g, 0)]
    t0 = time.perf_counter()
    pl = api.plan(api.make_problem(4096, specs), cache=None)
    prog, dplan = pl.exec_program, pl.decode_plan
    plan_s = time.perf_counter() - t0
    pieces = host_pieces(tree3, 0)
    codes = {}
    for name, (k, n) in mats.items():
        codes[name] = pieces[name][:k * n]
        codes[f"{name}_scales"] = pieces[f"{name}_scales"][:k * n // g]
    print(f"front door: {pl.summary()}; {dplan.n_units} decode slots "
          f"(widest {max(s.width for s in dplan.slots)} bits), "
          f"{prog.kernel.lanes} fused-decode lanes, {prog.n_pieces} pieces; "
          f"planned and lowered in {plan_s:.2f} s")
    if pl.metrics.c_max != FRONT_DOOR_C_MAX.get(cfg.d_model):
        raise AssertionError(f"front door C_max {pl.metrics.c_max} != "
                             f"{FRONT_DOOR_C_MAX.get(cfg.d_model)}")
    torch.cuda.synchronize()
    lp.launches = ld.fused_launches = ld.slot_launches = 0
    host = pl.pack(codes)
    buf = pl.pack(codes, backend="cuda", device=dev)
    want = pl.decode(host)
    fused = pl.decode(buf, backend="cuda", device=dev)
    per_slot = pl.decode(buf, backend="cuda", fused=False, device=dev)
    torch.cuda.synchronize()
    counts = {"pack_layout_fused": lp.launches,
              "decode_layout_fused": ld.fused_launches,
              "decode_slot": ld.slot_launches}
    if not np.array_equal(buf, host):
        raise AssertionError("front door: cuda pack != numpy pack")
    for what, out in (("numpy", want), ("cuda fused", fused),
                      ("cuda per-slot", per_slot)):
        bad = [k for k in codes if not np.array_equal(out[k], codes[k])]
        if bad:
            raise AssertionError(f"front door {what} decode differs: {bad}")
    if counts != {"pack_layout_fused": 1, "decode_layout_fused": 1,
                  "decode_slot": 1}:
        raise AssertionError(f"front door launches {counts}")
    print(f"front door: cuda pack == numpy pack ({buf.nbytes} B); numpy, "
          f"cuda fused and cuda per-slot decodes == the layer's codes "
          f"({len(codes)} arrays); launches {counts}; the per-slot launch "
          f"covers {n_units(dplan)} units")
    cmp = api.compare(api.PAPER_EXAMPLE, cache=None)
    print("compare(PAPER_EXAMPLE): " + "; ".join(
        f"{k} C_max={v.c_max} L_max={v.l_max} B_eff={v.efficiency:.4f}"
        for k, v in cmp.items()))
    if [cmp[k].c_max for k in ("naive", "homogeneous", "hls_padded",
                               "iris")] != [19, 13, 13, 9]:
        raise AssertionError("compare(PAPER_EXAMPLE) C_max != 19/13/13/9")
    for name, prob in (("PAPER_EXAMPLE", api.PAPER_EXAMPLE),
                       ("INV_HELMHOLTZ", api.INV_HELMHOLTZ)):
        p2 = api.plan(prob, cache=None)
        c2 = api.random_codes(prob, seed=0)
        torch.cuda.synchronize()
        lp.launches = ld.fused_launches = ld.slot_launches = 0
        b2 = p2.pack(c2, backend="cuda", device=dev)
        outs = [p2.decode(b2, backend="cuda", device=dev),
                p2.decode(b2, backend="cuda", fused=False, device=dev)]
        torch.cuda.synchronize()
        got = (lp.launches, ld.fused_launches, ld.slot_launches)
        if not np.array_equal(b2, p2.pack(c2)) or not all(
                np.array_equal(o[k], c2[k]) for o in outs for k in c2):
            raise AssertionError(f"{name}: cuda round trip failed")
        if got != (1, 1, 1):
            raise AssertionError(f"{name}: launches {got}, expected "
                                 f"(1, 1, 1)")
        print(f"{name}: cuda pack == numpy pack; cuda fused and per-slot "
              f"decodes == codes; {len(p2.exec_program.host_arrays)} of "
              f"{len(prob.arrays)} arrays wider than 32 bits, on the "
              f"kernels as two u32 fields; launches pack/fused/per-slot "
              f"{got}, the per-slot launch covering "
              f"{n_units(p2.decode_plan)} units")
    return pl, buf, counts["decode_slot"]


def quantized(params, spec) -> dict:
    """Each quantized matrix of the stack, by tree key: ``quantize`` of
    the dense weights (codes (L, K, N), scales (L, K/g, N))."""
    from repro_torch.quant import quantize

    blocks = params["blocks"][0]
    return {key: quantize(blocks[key.split("/")[0]][key.split("/")[1]],
                          spec) for key in MM_KEYS}


def host_pack(tree, params, qts, layer: int) -> np.ndarray:
    """Layer ``layer``'s stream packed on the host by ``pack_compiled``
    from the quantized codes, scale and norm bit patterns."""
    from repro_torch.core.exec_plan import pack_compiled
    from repro_torch.core.util import pad_bundle_elements
    from repro_torch.quant import bits16

    blocks = params["blocks"][0]
    norms = {"attn_norm": "norm1", "mlp_norm": "norm2"}
    data = {}
    for b in tree.manifest.bundle:
        if b.name in norms:
            v = bits16(blocks[norms[b.name]]["scale"][layer])
        else:
            name = b.name.removesuffix("_scales")
            key = next(k for k in MM_KEYS if k.endswith("/" + name))
            v = qts[key].codes[layer] if name == b.name \
                else bits16(qts[key].scales[layer])
        data[b.name] = v.reshape(-1).cpu().numpy()
    prog, lay = tree.exec_program(), tree.layout()
    return pack_compiled(lay, pad_bundle_elements(lay.problem, prog, data),
                         program=prog)


def counted_pack_tree(cfg, params, spec, dev) -> tuple:
    """``pack_tree`` with the pack launches counted from 0 just before it
    and read just after, and layer 0's pieces kept as ``pack_tree`` hands
    them to ``pack_pieces``.  Returns the tree, the launches and those
    pieces."""
    import torch

    from repro_torch import tree as tree_mod
    from repro_torch.kernels import layout_pack as lp

    handed = []
    real = tree_mod.pack_pieces

    def keep(prog, streams):
        if not handed:
            handed.extend(streams)
        return real(prog, streams)

    tree_mod.pack_pieces = keep
    try:
        torch.cuda.synchronize()
        lp.launches = 0
        tree = tree_mod.pack_tree(cfg, params, spec, device=dev)
        torch.cuda.synchronize()
        launches = lp.launches
    finally:
        tree_mod.pack_pieces = real
    return tree, launches, handed


def int4_pack(cfg, params, dev):
    """``pack_tree(int4/g32)`` at full width and depth, one
    ``pack_layout_fused`` launch per layer: every layer stream byte-equal
    to the host ``pack_compiled`` of the quantized pieces.  Returns the
    tree, its quantized matrices, the pack launches and layer 0's pieces
    as ``pack_tree`` handed them over."""
    from repro_torch.quant import QuantSpec

    spec = QuantSpec(bits=4, group_size=32)
    t0 = time.perf_counter()
    tree, launches, handed = counted_pack_tree(cfg, params, spec, dev)
    t_cuda = time.perf_counter() - t0
    qts = quantized(params, spec)
    t0 = time.perf_counter()
    same = sum(np.array_equal(tree.streams[la].cpu().numpy(),
                              host_pack(tree, params, qts, la))
               for la in range(tree.n_layers))
    t_host = time.perf_counter() - t0
    print(f"pack int4: {tree.summary()}; pack_tree {t_cuda:.2f} s "
          f"({launches} pack_layout_fused launches); host pack_compiled "
          f"{t_host:.2f} s; {same}/{tree.n_layers} layer streams byte-equal")
    if same != tree.n_layers or launches != tree.n_layers:
        raise AssertionError("int4 pack_tree differs from the host pack")
    return tree, qts, launches, handed


def stack_decode(trees, dev) -> int:
    """The restore path: ``unpack_streams`` of each tree (one
    ``decode_layout_fused`` launch per layer, counted) rebuilds scales and
    views equal to the tree's.  Then each layer's decode is held against
    the host unpack, the quantized codes and the bf16 scale patterns (for
    a tree with lane-packed views, also the views against
    ``pack_codes_u32`` of the decoded codes).  ``trees``: ``(tree,
    quantized matrices)`` pairs.  Returns the restore's launches."""
    import torch

    from repro_torch.kernels import layout_decode as ld
    from repro_torch.quant import bits16, pack_codes_u32
    from repro_torch.tree import unpack_streams

    launches = 0
    for tree, qts in trees:
        prog, lay = tree.exec_program(), tree.layout()
        g = tree.spec.group_size
        torch.cuda.synchronize()
        ld.fused_launches = 0
        t0 = time.perf_counter()
        back = unpack_streams(tree.manifest, tree.streams, tree.other,
                              device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        n_dec = ld.fused_launches
        launches += n_dec
        restore_dms, restore_events = device_call(
            lambda: unpack_streams(tree.manifest, tree.streams, tree.other,
                                   device=dev), iters=2)
        rebuilt = all(torch.equal(back.scales[k].view(torch.int16),
                                  v.view(torch.int16))
                      for k, v in tree.scales.items()) and \
            sorted(back.packed) == sorted(tree.packed) and \
            all(torch.equal(back.packed[k], v) for k, v in tree.packed.items())
        bad, views_ok = [], 0
        for la in range(tree.n_layers):
            out = ld.decode_layout_fused(lay, tree.streams[la], program=prog)
            host = host_pieces(tree, la)
            for name, v in host.items():
                if not np.array_equal(out[name].cpu().numpy()
                                      .astype(np.uint64), v):
                    bad.append((la, name, "host unpack"))
            views = True
            for key, (k, n) in tree.shapes.items():
                b = key.split("/")[1]
                codes = out[b][:k * n].reshape(k, n)
                if not torch.equal(codes, qts[key].codes[la].to(torch.int64)):
                    bad.append((la, b, "codes"))
                pat = bits16(qts[key].scales[la]).reshape(-1)
                if not torch.equal(out[f"{b}_scales"][:k * n // g],
                                   pat.to(torch.int64)):
                    bad.append((la, b, "scales"))
                if tree.packed and not torch.equal(
                        pack_codes_u32(codes, tree.spec.bits),
                        tree.packed[key][la]):
                    views = False
            views_ok += views
        views_note = (f"; kernel views == pack_codes_u32(decoded codes) in "
                      f"{views_ok}/{tree.n_layers} layers") \
            if tree.packed else ""
        print(f"restore int{tree.spec.bits}: unpack_streams "
              f"({back.provenance}) of {tree.n_layers} layers in "
              f"{restore_s * 1e3:.1f} ms wall, device "
              f"{fmt_ms(restore_dms)} ms over {restore_events} device "
              f"events ({n_dec} decode_layout_fused launches) rebuilds "
              f"scales{' and views' if tree.packed else ''}"
              f" equal to the tree's: {rebuilt}; "
              f"{tree.n_layers - len({b[0] for b in bad})}/{tree.n_layers} "
              f"layer decodes equal to the host unpack, the quantized codes "
              f"and the scale patterns{views_note}")
        if bad or not rebuilt or n_dec != tree.n_layers or (
                tree.packed and views_ok != tree.n_layers):
            raise AssertionError(f"restore int{tree.spec.bits}: "
                                 f"{bad[:5]} rebuilt={rebuilt}")
    return launches


def check_packed_matmul(tree, rng, dev) -> dict:
    """Each of the 7 int4 matrices at M in {1, 4, 8} against the plain
    version, and bit-equal to ``stream_matmul`` over the same layer's
    stream; timed at M=4, the served batch; plus one ragged shape."""
    import torch

    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.quant import QuantSpec, pack_codes_u32, quantize

    from repro_torch.kernels.stream_matmul import matmul_launch

    bits, g = tree.spec.bits, tree.spec.group_size
    max_err = 0.0
    layer = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "library_device_ms": 0.0, "bytes": 0, "flops": 0}
    for key in MM_KEYS:
        pw, sc = tree.packed[key][0], tree.scales[key][0]
        k, n = sc.shape[0] * g, sc.shape[1]
        for m in (1, 4, 8):
            x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
            got = pm.packed_matmul(x, pw, sc, bits=bits, group_size=g)
            want = pm.packed_matmul_plain(x, pw, sc, bits=bits, group_size=g)
            streamed = tree.matmul_direct(x, key, 0)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            if not torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL):
                raise AssertionError(
                    f"packed_matmul {key} M={m}: max |err| {err:.3g}")
            if not torch.equal(got, streamed):
                raise AssertionError(f"packed_matmul {key} M={m} differs "
                                     f"from stream_matmul")
            if m != SERVE_M:
                continue
            dense = pm.packed_matmul_plain(torch.eye(k, device=dev), pw, sc,
                                           bits=bits, group_size=g)
            ms = time_ms(lambda: pm.packed_matmul(x, pw, sc, bits=bits,
                                                  group_size=g))
            dms = device_ms(lambda: pm.packed_matmul(
                x, pw, sc, bits=bits, group_size=g), "packed_matmul_kernel")
            pms = time_ms(lambda: pm.packed_matmul_plain(
                x, pw, sc, bits=bits, group_size=g), iters=5)
            lms = time_ms(lambda: torch.matmul(x, dense))
            ldms = device_ms(lambda: torch.matmul(x, dense), None)
            nbytes = (x.numel() * 4 + pw.numel() * 4 + sc.numel() * 2
                      + m * n * 4)
            flops = 2 * m * k * n
            bms, _ = bound_ms(nbytes, flops)
            print(f"packed_matmul {key:11s} K={k:5d} N={n:5d} M={m}: "
                  f"kernel {ms:.4f} ms (device {fmt_ms(dms)} ms, grid "
                  f"{matmul_launch(m, k, n)[1]})  plain {pms:.4f} ms  "
                  f"library(matmul of dequantized W) {lms:.4f} ms (device "
                  f"{fmt_ms(ldms)} ms)  bound {bms:.5f} ms  max|err| "
                  f"{err:.3g}")
            layer["ms"] += ms
            layer["device_ms"] = add_ms(layer["device_ms"], dms)
            layer["plain_ms"] += pms
            layer["library_ms"] += lms
            layer["library_device_ms"] = add_ms(
                layer["library_device_ms"], ldms)
            layer["bytes"] += nbytes
            layer["flops"] += flops
    # one ragged shape: N and M off the tiles
    k, n, m = 96, 77, 3
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(dev)
    qt = quantize(w, QuantSpec(bits=bits, group_size=g))
    pw = pack_codes_u32(qt.codes, bits)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
    got = pm.packed_matmul(x, pw, qt.scales, bits=bits, group_size=g)
    want = pm.packed_matmul_plain(x, pw, qt.scales, bits=bits, group_size=g)
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    if not torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL):
        raise AssertionError(f"packed_matmul ragged: max |err| {err:.3g}")
    bms, by = bound_ms(layer["bytes"], layer["flops"])
    print(f"packed_matmul ragged int{bits} K={k} N={n} M={m}: max|err| "
          f"{err:.3g}")
    print(f"packed_matmul, one layer's 7 matmuls at M={SERVE_M}: kernel "
          f"{layer['ms']:.4f} ms back to back (device "
          f"{fmt_ms(layer['device_ms'])} ms, "
          f"{fmt_ms(layer['device_ms'] and layer['device_ms'] / 7)} ms per "
          f"launch)  plain {layer['plain_ms']:.4f} ms  library "
          f"{layer['library_ms']:.4f} ms (device "
          f"{fmt_ms(layer['library_device_ms'])} ms)  bound {bms:.5f} ms "
          f"({by}; "
          f"{layer['bytes']} B, {layer['flops']} f32 FLOPs); bit-equal to "
          f"stream_matmul on every matrix")
    return {"max_abs_err": max_err, "ms": layer["ms"],
            "device_ms": layer["device_ms"],
            "plain_ms": layer["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": layer["library_ms"],
            "library_device_ms": layer["library_device_ms"]}


def pack_words_flat(prog, pieces: dict) -> np.ndarray:
    """``pack_words``' flat u32 stream of a layer's pieces (the host
    unpack): a zero sentinel, every piece's low 32 bits in piece order,
    then the high halves of the pieces wider than 32 bits."""
    n = len(prog.piece_depths)
    low = [pieces[i] for i in range(n)]
    high = [pieces[i] >> np.uint64(32) for i in prog.host_arrays]
    return np.concatenate([np.zeros(1, np.uint64), *low, *high]) \
        .astype(np.uint32)


def check_pack_kernel(packs, dev) -> dict:
    """The whole ``pack_pieces`` of layer 0 of each tree (one
    ``pack_runs`` launch), from the pieces as ``pack_tree`` handed them
    over, against ``pack_runs_plain``, ``pack_words`` (the TPU kernel's
    form, over the flat u32 stream of the same pieces) and the layer's
    stream; timed back to back and on the device (every device event of
    the call's profiler window, which must hold one kernel).  Beside it
    ``pack_words``, held against its plain version.  The run table (and
    ``pack_words``' contribution tables) serve every layer: the bound
    counts them once per stack.  ``packs``: ``(tree, pieces)`` pairs.
    Returns the int4 tree's row."""
    import torch

    from repro_torch.kernels import layout_pack as lp
    from repro_torch.kernels.ref import words_tensor

    rows = {}
    for tree, streams in packs:
        prog = tree.exec_program()
        bits = tree.spec.bits
        table = lp.device_pack_runs(prog, dev)
        got = lp.pack_pieces(prog, streams)
        plain = lp.pack_runs_plain(table.runs, streams, prog.c_max,
                                   prog.words32)
        flat_t = words_tensor(
            pack_words_flat(prog, prog.unpack_indexed(
                tree.streams[0].cpu().numpy())), dev)
        src, scode = lp.device_pack_tables(prog, dev)
        words = lp.pack_words(flat_t, src, scode)
        torch.cuda.synchronize()
        if not torch.equal(got, tree.streams[0]) \
                or not torch.equal(lp.pack_runs(table, streams), plain) \
                or not torch.equal(words, plain.reshape(-1)):
            raise AssertionError(f"pack_layout_fused int{bits}: pack_pieces "
                                 "differs from pack_runs_plain, pack_words "
                                 "or the layer's stream")
        if not torch.equal(words, lp.pack_words_plain(flat_t, src, scode)):
            raise AssertionError("pack_words differs from its plain version")

        def call():
            lp.pack_pieces(prog, streams)

        before = lp.launches
        call()
        if lp.launches != before + 1:
            raise AssertionError(f"pack_pieces: {lp.launches - before} "
                                 "launches a call, expected 1")
        ms = time_ms(call)
        dms = one_kernel_ms(call, "pack_runs_kernel",
                            f"pack_layout_fused int{bits}")
        kms = device_ms(lambda: lp.pack_runs(table, streams),
                        "pack_runs_kernel")
        pms = time_ms(lambda: lp.pack_runs_plain(
            table.runs, streams, prog.c_max, prog.words32), iters=3)
        in_bytes = sum(s.numel() * s.element_size() for s in streams)
        out_bytes = got.numel()
        tab_bytes = (table.runs.numel() + table.row_start.numel()) * 4
        nbytes = in_bytes + prog.c_max * prog.words32 * 4
        bms, by = bound_ms(nbytes + tab_bytes / tree.n_layers, 0)
        cold, cold_by = bound_ms(nbytes + tab_bytes, 0)
        print(f"pack_layout_fused int{bits} layer (whole pack_pieces call): "
              f"{prog.n_pieces} pieces of {len(streams)} arrays "
              f"({', '.join(sorted({str(s.dtype) for s in streams}))}), "
              f"{table.runs.shape[0]} runs, {out_bytes} B out: {ms:.4f} ms "
              f"(device {fmt_ms(dms)} ms, 1 kernel a call; the kernel "
              f"{fmt_ms(kms)} ms)  plain {pms:.4f} ms  library none  "
              f"bound {bms:.6f} ms ({by}; {in_bytes} B of arrays as stored "
              f"+ {prog.c_max * prog.words32 * 4} B out, with the "
              f"{tab_bytes} B run table over {tree.n_layers} layers); "
              f"cold-L2 bound {cold:.6f} ms ({cold_by})  max|err| 0")
        wms = time_ms(lambda: lp.pack_words(flat_t, src, scode))
        wdms = device_ms(lambda: lp.pack_words(flat_t, src, scode),
                         "pack_fused_kernel")
        wtab = (src.numel() + scode.numel()) * 4
        wbytes = flat_t.numel() * 4 + words.numel() * 4
        wbms, _ = bound_ms(wbytes + wtab / tree.n_layers, 0)
        print(f"pack_words int{bits} layer (the TPU kernel's form): "
              f"K={src.shape[0]}, {words.numel()} words: kernel {wms:.4f} ms "
              f"(device {fmt_ms(wdms)} ms)  bound {wbms:.6f} ms (bytes; "
              f"{wbytes} B with the {wtab} B of tables over {tree.n_layers} "
              f"layers)  == plain")
        rows[bits] = {"max_abs_err": 0.0, "ms": ms, "device_ms": dms,
                      "kernel_device_ms": kms, "plain_ms": pms,
                      "bound_ms": bms, "bound_by": by, "cold_bound_ms": cold,
                      "library_ms": None,
                      "pack_words": {"ms": wms, "device_ms": wdms,
                                     "bound_ms": wbms}}
    return rows[4]


def check_decode_kernel(trees, dev) -> dict:
    """The whole ``decode_layout_fused`` of one layer of each tree (one
    ``decode_pieces`` launch), against the plain version and against the
    TPU kernel's form (``decode_grid_plain``, then the gather and the
    halves joined); timed back to back and on the device (every kernel of
    the call's profiler window, which must hold one), with the
    ``decode_grid`` kernel beside it, held against ``decode_grid_plain``.
    The descriptors (and the grid's
    slot table) serve every layer: the bound counts them once per stack.
    Returns the first tree's row."""
    import torch

    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels.ref import U32

    rows = []
    for tree in trees:
        prog, lay = tree.exec_program(), tree.layout()
        buf = tree.streams[0]
        words = tree.layer_stream_words(0).reshape(prog.c_max, prog.words32)
        desc = ld.device_piece_table(prog, dev)
        got = ld.decode_pieces(words, desc)
        tab, flat = ld.device_decode_tables(prog, dev)
        fields = ld.decode_grid_plain(words, tab).reshape(-1)[flat] \
            .to(torch.int64) & U32
        grid_way = fields[:prog.n_pieces].clone()
        hi = prog.n_pieces
        for i in prog.host_arrays:
            lo, n = prog.piece_base[i], prog.piece_depths[i]
            grid_way[lo:lo + n] |= fields[hi:hi + n] << 32
            hi += n
        whole = ld.decode_layout_fused(lay, buf, program=prog)
        grid = ld.decode_grid(words, tab)
        torch.cuda.synchronize()
        if not torch.equal(got, ld.decode_pieces_plain(words, desc)) \
                or not torch.equal(got, grid_way) \
                or not torch.equal(got, torch.cat(list(whole.values()))):
            raise AssertionError("decode_layout_fused differs from its "
                                 "plain version or the grid's gather")
        if not torch.equal(grid, ld.decode_grid_plain(words, tab)):
            raise AssertionError("decode_grid differs from its plain "
                                 "version")

        def call():
            ld.decode_layout_fused(lay, buf, program=prog)

        before = ld.fused_launches
        call()
        if ld.fused_launches != before + 1:
            raise AssertionError("decode_layout_fused: "
                                 f"{ld.fused_launches - before} launches a "
                                 "call, expected 1")
        ms = time_ms(call)
        dms = one_kernel_ms(call, "decode_pieces_kernel",
                            f"decode_layout_fused int{tree.spec.bits}")
        kms = device_ms(lambda: ld.decode_pieces(words, desc),
                        "decode_pieces_kernel")
        pms = time_ms(lambda: ld.decode_pieces_plain(words, desc), iters=5)
        desc_bytes = desc.numel() * desc.element_size()
        nbytes = words.numel() * 4 + got.numel() * 8
        bms, by = bound_ms(nbytes + desc_bytes / tree.n_layers, 0)
        cold, cold_by = bound_ms(nbytes + desc_bytes, 0)
        gms = time_ms(lambda: ld.decode_grid(words, tab))
        gdms = device_ms(lambda: ld.decode_grid(words, tab),
                         "decode_grid_kernel")
        gbytes = words.numel() * 4 + tab.numel() * 4
        gbms, _ = bound_ms(gbytes + tab.numel() * 4 / tree.n_layers, 0)
        print(f"decode_layout_fused int{tree.spec.bits} layer (whole call): "
              f"{got.numel()} pieces of {len(prog.piece_depths)} arrays "
              f"into int64: {ms:.4f} ms (device {fmt_ms(dms)} ms, "
              f"1 kernel a call; the kernel {fmt_ms(kms)} ms)  "
              f"plain {pms:.4f} ms  library none  bound {bms:.6f} ms ({by}; "
              f"{nbytes} B with the {desc_bytes} B of descriptors over "
              f"{tree.n_layers} layers); cold-L2 bound {cold:.6f} ms "
              f"({cold_by})  max|err| 0")
        print(f"decode_grid int{tree.spec.bits} layer (the TPU kernel's "
              f"grid): {prog.c_max} x {tab.shape[1]} entries: kernel "
              f"{gms:.4f} ms (device {fmt_ms(gdms)} ms)  bound {gbms:.6f} ms "
              f"(bytes, the grid written as int32)  == plain")
        rows.append({"max_abs_err": 0.0, "ms": ms, "device_ms": dms,
                     "kernel_device_ms": kms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "cold_bound_ms": cold,
                     "library_ms": None,
                     "grid": {"ms": gms, "device_ms": gdms,
                              "bound_ms": gbms}})
    return rows[0]


def check_decode_slot(pl, buf, dev) -> dict:
    """The front door's whole per-slot decode (``decode_layout(fused=
    False)``: every unit of the plan in one ``decode_units`` launch)
    against the plain version, timed back to back and on the device
    (every kernel of its profiler window, which must hold one); then a
    sample of the units, one ``decode_slot`` call each, against
    ``decode_slot_plain``."""
    import torch

    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels.ops import buffer_to_u32, decode_layout

    plan = pl.decode_plan
    dbuf = torch.from_numpy(buf).to(dev)
    rows = ld.rows_u32(dbuf)
    table = ld.device_unit_table(plan, pl.problem, dev)
    got = ld.decode_units(rows, table)
    torch.cuda.synchronize()
    if not torch.equal(got, ld.decode_units_plain(rows, table)):
        raise AssertionError("decode_units differs from its plain version")

    def call():
        decode_layout(pl.layout, dbuf, plan=plan, fused=False)

    before = ld.slot_launches
    call()
    if ld.slot_launches != before + 1:
        raise AssertionError(f"the per-slot decode: "
                             f"{ld.slot_launches - before} launches a call, "
                             "expected 1")
    ms = time_ms(call)
    dms = one_kernel_ms(call, "decode_units_kernel", "the per-slot decode")
    kms = device_ms(lambda: ld.decode_units(rows, table),
                    "decode_units_kernel")
    pms = time_ms(lambda: ld.decode_units_plain(rows, table), iters=3,
                  warmup=1)
    words = buffer_to_u32(dbuf)
    sample = plan.slots[::max(1, len(plan.slots) // 50)]
    for s in sample:
        offs = torch.tensor([s.bit_offset + j * s.width
                             for j in range(s.lanes)], dtype=torch.int32,
                            device=dev)
        slab = words[s.start_cycle:s.start_cycle + s.n_cycles]
        w = min(s.width, 32)
        if not torch.equal(ld.decode_slot(slab, offs, w),
                           ld.decode_slot_plain(slab, offs, w)):
            raise AssertionError("decode_slot differs from its plain "
                                 "version")
    tab_bytes = table.units.numel() * 4 + table.prefix.numel() * 4
    nbytes = dbuf.numel() + tab_bytes + got.numel() * 8
    bms, by = bound_ms(nbytes, 0)
    print(f"decode_slot, the front door's whole per-slot decode: "
          f"{table.units.shape[0]} units, {table.n_fields} codes into int64 "
          f"in 1 launch: {ms:.4f} ms (device {fmt_ms(dms)} ms, 1 kernel "
          f"a call; the kernel {fmt_ms(kms)} ms)  plain "
          f"{pms:.4f} ms  library none  bound {bms:.6f} ms ({by}; {nbytes} "
          f"B)  max|err| 0; {len(sample)} one-unit decode_slot calls == "
          f"plain")
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": dms,
            "kernel_device_ms": kms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": None}


def profile_steps(engine, prompts, label: str, n_steps: int = 4) -> None:
    """``torch.profiler`` over a few steady steps of ``engine`` (4 of
    ``prompts``, 64 new tokens each): time by operator, and the device's
    busy share of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import EngineRequest

    for uid, prompt in enumerate(prompts[:4]):
        engine.submit(EngineRequest(uid=uid, prompt=prompt,
                                    max_new_tokens=64))
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0],
                                              "self_device_time_total") \
        else "self_cuda_time_total"
    # device-side rows only (kernels, memcpy/memset): the aten rows repeat
    # the time of the kernels they launched
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(getattr(e, key) for e in dev)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"profile ({label}): {n_steps} steps in {wall * 1e3:.2f} ms wall "
          f"(profiler on); device busy {dev_us / 1e3:.2f} ms "
          f"({dev_us / 1e4 / wall:.1f}% of wall); "
          f"{launches / n_steps:.0f} kernel launches per step")
    print(events.table(sort_by="self_cpu_time_total", row_limit=18,
                       max_name_column_width=48))
    print(events.table(sort_by=key, row_limit=12, max_name_column_width=48))


def jamba_config():
    """jamba-1.5-large-398b at its full widths, cut to fit one card:
    returns (config, the cuts as text)."""
    import dataclasses

    from repro_torch.configs import JAMBA_1_5_LARGE

    cfg = dataclasses.replace(JAMBA_1_5_LARGE, n_layers=8, moe=None)
    cuts = ("n_layers 72 -> 8 (one period: 7 Mamba + 1 GQA attention "
            "sublayer); moe -> None (every sublayer takes the dense MLP of "
            f"d_ff {cfg.d_ff}; 16 experts x 3 x 8192 x 24576 bf16 = 19.3 GB "
            "per MoE sublayer would not fit one card beside the rest)")
    return cfg, cuts


def param_leaves(tree):
    """(container, key, tensor) for every leaf of a parameter tree."""
    stack = [tree]
    while stack:
        node = stack.pop()
        for key, val in list(node.items() if isinstance(node, dict)
                             else enumerate(node)):
            if isinstance(val, (dict, list)):
                stack.append(val)
            else:
                yield node, key, val


def mem_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def scan_bound(q, v, out) -> tuple[float, str, float, int]:
    """Least time of one ssd_scan call as the kernel computes it (tensor
    cores): q/k/v/logw read once and the output written once, against its
    FLOPs with the masked triangle skipped (2 C(C+1)/2 (dk + dv) for the
    scores and their product with v, 2 C dk dv each for the carried
    state's read and update, per chunk of the kernel's tile C) at the bf16
    tensor-core peak.  Returns it, what bounds it, the f32 CUDA-core
    figure (the bound of the first design) and the tile."""
    from repro_torch.kernels.linear_scan import scan_launch

    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = scan_launch(b, h, dk, dv, q.element_size())[0]
    n_chunks = -(-t // c)
    nbytes = (2 * q.numel() * q.element_size() + v.numel() * v.element_size()
              + b * t * h * 4 + out.numel() * out.element_size())
    flops = b * h * n_chunks * (c * (c + 1) * (dk + dv) + 4 * c * dk * dv)
    tb, tt = nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS
    f32 = max(tb, flops / F32_FLOPS) * 1e3
    return max(tb, tt) * 1e3, "bytes" if tb >= tt else "operations", f32, c


def sweep_scan_launch(q, k, v, logw, want) -> None:
    """Every (tile, dv slice) launch shape of ``ssd_scan`` whose block fits
    at these inputs, each held against the plain output ``want`` and timed
    back to back: the evidence for the shape ``scan_launch`` picks."""
    import torch

    from repro_torch.kernels import linear_scan as ls

    b, _, h, dk = q.shape
    dv = v.shape[-1]
    orig = ls.scan_launch
    pick = orig(b, h, dk, dv, q.element_size())
    times = []
    try:
        for tile in (64, 32, 16):
            for dvs in (64, 32, 16):
                smem = ls.scan_smem(tile, dvs, dk, q.element_size())
                strips = dvs // 16 * -(-dk // 64)
                if dvs > -(-dv // 16) * 16 or strips > 8 \
                        or smem > ls.MAX_SMEM:
                    continue
                ls.scan_launch = lambda *a, s=(tile, dvs, smem): s
                got = ls.ssd_scan(q, k, v, logw)
                torch.cuda.synchronize()
                if not torch.allclose(got.float(), want.float(),
                                      **SCAN_BF16_TOL):
                    raise AssertionError(f"ssd_scan tile {tile} dv slice "
                                         f"{dvs} differs from plain")
                ms = time_ms(lambda: ls.ssd_scan(q, k, v, logw), iters=10)
                times.append(f"{tile}/{dvs} {ms:.4f}")
    finally:
        ls.scan_launch = orig
    print(f"ssd_scan launch shapes at B={b} H={h} dk={dk} dv={dv} "
          f"{q.dtype} (tile/dv slice ms; picked {pick[0]}/{pick[1]}): "
          + ", ".join(times))


def check_ssd_scan(cfg, params, toks, rng, dev) -> dict:
    """The kernel against its plain version on the layer-0 Mamba inputs of
    the real prefill (bf16, timed) and on a ragged f32 case (T=1000 of
    the same inputs, widened, with a random state0 and the final state)."""
    import torch

    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.mamba import _ssm_inputs
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import period_params

    p0 = period_params(params["blocks"][0], 0)
    h = apply_norm(cfg, p0["norm1"], Model(cfg)._embed(params, toks))
    _, _, bk, cq, v, log_a = _ssm_inputs(cfg, p0["mamba"], h)
    got = ls.ssd_scan(cq, bk, v, log_a)
    want = ls.ssd_scan_plain(cq, bk, v, log_a)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.dtype != cq.dtype or not torch.isfinite(got).all() or \
            not torch.allclose(got.float(), want.float(), **SCAN_BF16_TOL):
        raise AssertionError(f"ssd_scan bf16 prefill inputs: max |err| "
                             f"{err:.3g}")
    t_r = 1000
    args32 = [a[:, :t_r].float() for a in (cq, bk, v)] + [log_a[:, :t_r]]
    s0 = torch.from_numpy(rng.standard_normal(
        (cq.shape[0], cq.shape[2], cq.shape[3], v.shape[3]),
        np.float32)).to(dev)
    g32, gs = ls.ssd_scan(*args32, state0=s0, return_state=True)
    w32, ws = ls.ssd_scan_plain(*args32, state0=s0, return_state=True)
    torch.cuda.synchronize()
    err32 = max(float((g32 - w32).abs().max()), float((gs - ws).abs().max()))
    if not (torch.allclose(g32, w32, **SCAN_F32_TOL)
            and torch.allclose(gs, ws, **SCAN_F32_TOL)):
        raise AssertionError(f"ssd_scan ragged f32: max |err| {err32:.3g}")
    sweep_scan_launch(cq, bk, v, log_a, want)
    ms = time_ms(lambda: ls.ssd_scan(cq, bk, v, log_a), iters=20)
    dms = device_ms(lambda: ls.ssd_scan(cq, bk, v, log_a), "ssd_scan_kernel",
                    iters=20)
    pms = time_ms(lambda: ls.ssd_scan_plain(cq, bk, v, log_a), iters=5)
    bms, by, f32, tile = scan_bound(cq, v, got)
    b, t, hh, dk = cq.shape
    _, dvs, smem = ls.scan_launch(b, hh, dk, v.shape[-1], cq.element_size())
    print(f"ssd_scan bf16 B={b} T={t} H={hh} dk={dk} dv={v.shape[-1]} "
          f"(layer-0 Mamba inputs of the prefill; tile {tile}, dv slice "
          f"{dvs}, {b * hh * -(-v.shape[-1] // dvs)} blocks of {smem} B): "
          f"kernel {ms:.4f} ms (device {fmt_ms(dms)} ms)  plain {pms:.4f} ms  "
          f"library none  bound {bms:.4f} ms ({by}, tensor cores; f32 "
          f"CUDA-core figure {f32:.4f} ms)  max|err| {err:.3g} (largest "
          f"|output| {float(want.float().abs().max()):.4g}); ragged f32 "
          f"T={t_r} with state0: max|err| (output, final state) "
          f"{err32:.3g} (largest |final state| {float(ws.abs().max()):.4g})")
    return {"max_abs_err": max(err, err32), "ms": ms, "device_ms": dms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def check_wide_scan(dev) -> dict:
    """``ssd_scan`` at Mamba-2's head widths (Dao & Gu, arXiv:2405.21060:
    d_state 128, head_dim 64), bf16, B=2, T=1024, H=256, seeded random
    inputs made on the card, against the plain version and timed."""
    import torch

    from repro_torch.kernels import linear_scan as ls

    b, t, h, dk, dv = PREFILL_B, PREFILL_T, 256, 128, 64
    gen = torch.Generator(device=dev).manual_seed(128)
    q, k = (0.5 * torch.randn((b, t, h, dk), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    v = (0.5 * torch.randn((b, t, h, dv), generator=gen, device=dev)) \
        .to(torch.bfloat16)
    logw = -torch.nn.functional.softplus(
        0.5 * torch.randn((b, t, h), generator=gen, device=dev))
    got = ls.ssd_scan(q, k, v, logw)
    want = ls.ssd_scan_plain(q, k, v, logw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got).all() or \
            not torch.allclose(got.float(), want.float(), **SCAN_BF16_TOL):
        raise AssertionError(f"ssd_scan dk={dk} dv={dv}: max |err| "
                             f"{err:.3g}")
    ms = time_ms(lambda: ls.ssd_scan(q, k, v, logw), iters=20)
    dms = device_ms(lambda: ls.ssd_scan(q, k, v, logw), "ssd_scan_kernel",
                    iters=20)
    pms = time_ms(lambda: ls.ssd_scan_plain(q, k, v, logw), iters=3)
    bms, by, f32, tile = scan_bound(q, v, got)
    _, dvs, smem = ls.scan_launch(b, h, dk, dv, q.element_size())
    print(f"ssd_scan bf16 B={b} T={t} H={h} dk={dk} dv={dv} (Mamba-2's "
          f"d_state 128 x head_dim 64; tile {tile}, dv slice {dvs}, "
          f"{b * h * -(-dv // dvs)} blocks of {smem} B): kernel {ms:.4f} ms "
          f"(device {fmt_ms(dms)} ms)  plain {pms:.4f} ms  library none  "
          f"bound "
          f"{bms:.4f} ms ({by}, tensor cores; f32 CUDA-core figure "
          f"{f32:.4f} ms)  max|err| {err:.3g} (largest |output| "
          f"{float(want.float().abs().max()):.4g})")
    return {"max_abs_err": err, "ms": ms, "device_ms": dms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def prefill_jamba(cfg, params, toks) -> int:
    """The main path's prefill: ``build_prefill_step`` at (B, T), with the
    ``ssd_scan`` launches counted.  Returns them."""
    import torch

    from repro_torch.kernels import linear_scan as ls
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.transformer import n_periods, period_template

    step = build_prefill_step(cfg)
    torch.cuda.synchronize()
    ls.launches = 0
    t0 = time.perf_counter()
    logits, caches = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ls.launches
    b, t = toks.shape
    n_mamba = n_periods(cfg) * sum(s.mixer == "mamba"
                                   for s in period_template(cfg))
    finite = bool(torch.isfinite(logits).all())
    shapes = [tuple(k.shape) for k, _ in caches]
    print(f"prefill jamba B={b} T={t}: logits {tuple(logits.shape)} "
          f"{logits.dtype} finite={finite}; attention caches (k, v) "
          f"{shapes}; ssd_scan launches {launches}; {wall * 1e3:.1f} ms "
          f"wall (first call); peak device memory {mem_gb():.2f} GB")
    want = (n_periods(cfg), b, t, cfg.n_kv_heads, cfg.head_dim)
    if logits.shape != (b, t, cfg.vocab_size) or not finite or \
            shapes != [want] or launches != n_mamba:
        raise AssertionError(f"prefill jamba: launches {launches} (expected "
                             f"{n_mamba}), caches {shapes}, finite {finite}")
    return launches


def decode_vs_prefill(cfg, params, toks, tol: dict, what: str) -> None:
    """Teacher-forced decode (``build_serve_step``: ``recurrent_step``,
    decode attention) against the prefill's logits (``ssd_scan``, flash
    attention) over the same tokens.  Every logit within ``tol``; in f32
    also the greedy argmax at every position."""
    import torch

    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.model import Model

    b, t = toks.shape
    par, _ = build_prefill_step(cfg)(params, {"tokens": toks})
    step = build_serve_step(cfg)
    state = Model(cfg).init_decode_state(b, 256, device=toks.device)
    seq = []
    for i in range(t):
        lg, state = step(params, state, toks[:, i])
        seq.append(lg)
    seq = torch.stack(seq, dim=1).float()
    par = par.float()
    err = float((seq - par).abs().max())
    top2 = par.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = seq.argmax(-1) == par.argmax(-1)
    ok_tol = torch.allclose(seq, par, **tol)
    strict = cfg.dtype == "float32"
    print(f"decode == prefill ({what}), {b} prompts x {t} tokens: max "
          f"|dlogit| {err:.4g} (tolerance rtol {tol['rtol']} atol "
          f"{tol['atol']}; largest logit {float(par.abs().max()):.4g}); "
          f"greedy argmax equal at {int(agree.sum())}/{agree.numel()} "
          f"positions (prefill top-2 margins where not: "
          f"{[round(float(m), 5) for m in margin[~agree]]}; smallest margin "
          f"{float(margin.min()):.4g}); peak device memory {mem_gb():.2f} GB")
    if not ok_tol or (strict and not bool(agree.all())):
        raise AssertionError(f"decode != prefill ({what})")


def serve_jamba(cfg, params, rng) -> dict:
    """The main path's serving: Engine(DenseAdapter), 8 requests, batch 4,
    max_seq 256, prompts of 2-5 tokens, 8 new tokens each; ms per step
    against the decode step's bytes bound."""
    import torch

    from repro_torch.engine import (
        DenseAdapter,
        Engine,
        EngineConfig,
        EngineRequest,
    )
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models.model import Model

    model = Model(cfg)
    engine = Engine(DenseAdapter(model, params),
                    EngineConfig(batch_size=4, max_seq=256,
                                 max_backlog=None))
    requests = [EngineRequest(uid=uid, prompt=rng.integers(
        1, cfg.vocab_size, int(rng.integers(2, 6))).tolist(),
        max_new_tokens=8) for uid in range(8)]
    for req in requests:
        engine.submit(req)
    torch.cuda.synchronize()
    ls.launches = 0
    t0 = time.perf_counter()
    stats = engine.run_until_drained(max_steps=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a step reads every weight but the embedding table (4 of its rows),
    # and reads and writes the SSM state; the KV cache (<= 4.2 MB) is left
    # out, so this is a lower bound
    w_bytes = sum(x.numel() * x.element_size()
                  for _, _, x in param_leaves(params)) \
        - params["embed"].numel() * params["embed"].element_size() \
        + 4 * cfg.d_model * params["embed"].element_size()
    ssm = engine.state["ssm"]
    step_bytes = w_bytes + 2 * ssm.numel() * ssm.element_size()
    bms = step_bytes / HBM_BYTES_PER_S * 1e3
    per_step = wall / max(1, stats.steps) * 1e3
    print(f"serve jamba (dense): completed={stats.completed}/"
          f"{len(requests)} steps={stats.steps} "
          f"tokens={stats.tokens_generated} wall={wall:.3f} s "
          f"tokens/s={stats.tokens_generated / wall:.2f} ms/decode step="
          f"{per_step:.3f} (bound {bms:.3f} ms: {step_bytes / 1e9:.2f} GB "
          f"at 3.35 TB/s, {per_step / bms:.1f}x); ssd_scan launches "
          f"{ls.launches}; peak device memory {mem_gb():.2f} GB")
    if stats.completed != len(requests):
        raise AssertionError(f"completed {stats.completed}/{len(requests)}")
    for req in requests:
        if len(req.generated) != 8 or not all(
                0 <= t < cfg.vocab_size for t in req.generated):
            raise AssertionError(f"request {req.uid}: bad tokens "
                                 f"{req.generated}")
    return {"ms_per_step": per_step, "bound_ms": bms}


def run_jamba(cfg, cuts: str, dev) -> tuple[dict, int]:
    """The hybrid slice at ``cfg``: weights, the ssd_scan kernel line, the
    prefill (counted), decode == prefill in bf16 and f32, and the dense
    serve.  Returns the kernel's row and its prefill launches."""
    import dataclasses

    import torch

    from repro_torch.engine import DenseAdapter, Engine, EngineConfig
    from repro_torch.models.model import Model
    from repro_torch.models.params import init_params

    rng = np.random.default_rng(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, _, x in param_leaves(params))
    n_bytes = sum(x.numel() * x.element_size()
                  for _, _, x in param_leaves(params))
    print(f"jamba weights: {cfg.name} at d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, SSM "
          f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} heads of "
          f"{cfg.ssm.d_state} x {cfg.ssm.head_dim}, vocab {cfg.vocab_size}; "
          f"cuts: {cuts}; {n_params / 1e9:.4f} B parameters "
          f"(param_count {cfg.param_count() / 1e9:.4f} B), "
          f"{n_bytes / 1e9:.3f} GB, seeded in "
          f"{time.perf_counter() - t0:.2f} s; peak device memory "
          f"{mem_gb():.2f} GB")
    if n_params != cfg.param_count():
        raise AssertionError("parameter tree != param_count()")
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (PREFILL_B, PREFILL_T))).to(dev)
    row = check_ssd_scan(cfg, params, toks, rng, dev)
    row["dk128_dv64"] = check_wide_scan(dev)
    launches = prefill_jamba(cfg, params, toks)
    short = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16))).to(dev)
    decode_vs_prefill(cfg, params, short,
                      dict(rtol=0.0, atol=DECODE_BF16_ATOL), "bf16")
    serve_jamba(cfg, params, rng)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(2, 6)))
               .tolist() for _ in range(4)]
    profile_steps(Engine(DenseAdapter(Model(cfg), params),
                         EngineConfig(batch_size=4, max_seq=256,
                                      max_backlog=None)),
                  prompts, "jamba dense bf16")
    # the same weights widened to f32 (exact), leaf by leaf in place
    torch.cuda.empty_cache()
    for node, key, val in param_leaves(params):
        node[key] = val.float()
    del val
    decode_vs_prefill(dataclasses.replace(cfg, dtype="float32"), params,
                      short, DECODE_F32_TOL, "f32, the same weights")
    return row, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    times = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in times.items())})")
    for name in build.KERNELS:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    dev = torch.device("cuda")
    kernels, ckpt = run(SMOLLM_135M, dev)
    torch.cuda.empty_cache()       # the smollm trees are gone with run()
    cfg, cuts = jamba_config()
    row, launches = run_jamba(cfg, cuts, dev)
    kernels.append({"name": "ssd_scan", "route": "cuda",
                    "source": "src/repro_torch/csrc/ssd_scan.cu",
                    "replaces": "src/repro/kernels/linear_scan.py:92",
                    "launches": launches, **row})
    print(json.dumps({"checkpoint": ckpt}))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(cfg, dev) -> tuple[list[dict], dict]:
    """Every smollm phase after the build, on ``cfg`` (smollm-135m at full
    width and depth from :func:`main`); returns the ``kernels`` rows of
    its six kernels and the checkpoint phase's figures."""
    import torch

    from repro_torch.engine import Engine, EngineConfig, PackedAdapter
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    tree, pack3_launches, pieces3 = counted_pack_tree(
        cfg, params, QuantSpec(bits=3, group_size=32), dev)
    tree.stream_words()
    torch.cuda.synchronize()
    print(f"pack int3: {tree.summary()} in {time.perf_counter() - t0:.2f} s "
          f"({pack3_launches} pack_layout_fused launches)")

    rows = {"stream_matmul": check_stream_matmul(tree, rng, dev),
            "stream_attention": check_stream_attention(cfg, rng, dev)}
    # its own generator: the later phases draw what they drew before
    rows["stream_attention"]["smax_2048"] = check_long_attention(
        cfg, np.random.default_rng(2048), dev)
    rows["stream_attention"]["rep12"] = check_rep12_attention(dev)
    pl, buf, slot_launches = front_door(cfg, tree, dev)
    tree4, qts4, pack4_launches, pieces4 = int4_pack(cfg, params, dev)
    if pack3_launches != tree.n_layers:
        raise AssertionError(f"int3 pack_tree: {pack3_launches} pack "
                             f"launches, expected {tree.n_layers}")
    decode_launches = stack_decode(
        ((tree, quantized(params, tree.spec)), (tree4, qts4)), dev)
    del params
    rows["packed_matmul"] = check_packed_matmul(tree4, rng, dev)
    rows["pack_layout_fused"] = check_pack_kernel(
        ((tree, pieces3), (tree4, pieces4)), dev)
    rows["decode_layout_fused"] = check_decode_kernel((tree, tree4), dev)
    rows["decode_slot"] = check_decode_slot(pl, buf, dev)

    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(2, 6))).tolist()
               for _ in range(8)]
    per_layer = {"stream_attention": cfg.n_layers}
    decode_check(cfg, tree4, rng, dev, kv_bits=4)
    counts4, _, _ = serve(cfg, tree4, prompts, 4,
                          {**per_layer, "packed_matmul": 7 * cfg.n_layers})
    decode_check(cfg, tree, rng, dev, kv_bits=3)
    counts3, tokens3, ms3 = serve(
        cfg, tree, prompts, 3,
        {**per_layer, "stream_matmul": 7 * cfg.n_layers})
    ckpt = checkpoint_phase(cfg, tree, tree4, prompts, dev,
                            (tokens3, ms3))
    profile_steps(Engine(PackedAdapter(cfg, tree, kv="packed", kv_bits=3),
                         EngineConfig(batch_size=4, max_seq=256,
                                      max_backlog=None)),
                  prompts, "int3 weights / int3 KV")
    profile_steps(Engine(PackedAdapter(cfg, tree4, kv="packed", kv_bits=4),
                         EngineConfig(batch_size=4, max_seq=256,
                                      max_backlog=None)),
                  prompts, "int4 weights / int4 KV")

    launches = {"stream_matmul": counts3["stream_matmul"],
                "stream_attention": counts3["stream_attention"],
                "packed_matmul": counts4["packed_matmul"],
                "pack_layout_fused": pack3_launches + pack4_launches,
                "decode_layout_fused": decode_launches,
                "decode_slot": slot_launches}
    meta = {
        "stream_matmul": ("src/repro_torch/csrc/stream_matmul.cu",
                          "src/repro/kernels/stream_matmul.py:183"),
        "stream_attention": ("src/repro_torch/csrc/stream_attention.cu",
                             "src/repro/kvcache/kernels/"
                             "stream_attention.py:99"),
        "packed_matmul": ("src/repro_torch/csrc/packed_matmul.cu",
                          "src/repro/kernels/packed_matmul.py:128"),
        "pack_layout_fused": ("src/repro_torch/csrc/layout_pack.cu",
                              "src/repro/kernels/layout_pack.py:125"),
        "decode_layout_fused": ("src/repro_torch/csrc/layout_decode.cu",
                                "src/repro/kernels/layout_decode.py:135"),
        "decode_slot": ("src/repro_torch/csrc/layout_decode.cu",
                        "src/repro/kernels/layout_decode.py:234"),
    }
    kernels = []
    for name, row in rows.items():
        src, replaces = meta[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **row})
    return kernels, ckpt


if __name__ == "__main__":
    sys.exit(main())
