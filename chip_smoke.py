#!/usr/bin/env python3
"""On-card smoke check of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card

1. Prints the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. Builds every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time.
3. Packs smollm-135m at full width and depth (30 layers, seeded random
   weights) into int3 Iris streams, then holds each kernel against its
   plain PyTorch version on the card at the main path's shapes:
   ``stream_matmul`` for the 7 matrices of a layer at M in {1, 4, 8} (the
   decode step pads M to 8) plus one ragged shape, and
   ``stream_attention`` at B=4, smax=256, H=9, Hkv=3, hd=64, int3.  Prints
   max errors and times: the kernel, its plain version, one PyTorch
   library call of the same function as a yardstick (never used by the
   port), and the least time the card could take (bytes over 3.35 TB/s
   or f32 FLOPs over 67 TFLOP/s, whichever is larger).  All layers share
   one set of offset tables, so the bound counts them once per decode
   step, spread over the layers; the cold-L2 figure (tables read on
   every call) is printed beside it.
4. Serves: 8 teacher-forced decode steps with ragged slots and positions
   through the kernels, each against the same step through the plain
   versions over the KV pages the kernels' step wrote, then ``Engine`` with ``PackedAdapter(kv="packed",
   kv_bits=3)``, batch 4, max_seq 256, 8 requests of 16 new tokens.
   Launch counters are zeroed just before the run and read just after;
   both kernels must have launched.  Then a ``torch.profiler`` window
   over 4 steady engine steps: time by operator, kernel launches per
   step and the device's busy share of the window.
5. Prints one JSON ``kernels`` line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

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

#: H100 SXM data-sheet peaks (NVIDIA: 3.35 TB/s HBM3, 67 TFLOP/s f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def check_stream_matmul(tree, rng, dev) -> dict:
    """Each of the 7 matrices at M in {1, 4, 8} plus one ragged shape.
    The bound counts the offset tables once per decode step, over the
    tree's layers, as the main path and the timed repeats read them."""
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
    layer = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "bytes": 0, "table_bytes": 0, "flops": 0}
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
            if m != 8:
                continue
            # the main path's shape: M padded to 8 rows
            dense = sm.stream_matmul_plain(
                torch.eye(k, device=dev), words, w_tab, s_tab, bits=bits,
                group_size=g)
            ms = time_ms(lambda: sm.stream_matmul(
                x, words, w_tab, s_tab, bits=bits, group_size=g))
            pms = time_ms(lambda: sm.stream_matmul_plain(
                x, words, w_tab, s_tab, bits=bits, group_size=g), iters=5)
            lms = time_ms(lambda: torch.matmul(x, dense))
            # the tables serve every layer: read once per decode step
            tab_bytes = (w_tab.numel() + s_tab.numel()) * 4
            nbytes = (x.numel() * 4 + -(-k * n * bits // 8)
                      + s_tab.numel() * 2 + m * n * 4)
            flops = 2 * m * k * n
            bms, _ = bound_ms(nbytes + tab_bytes / n_layers, flops)
            print(f"stream_matmul {key:11s} K={k:5d} N={n:5d} M={m}: "
                  f"kernel {ms:.4f} ms  plain {pms:.4f} ms  "
                  f"library(matmul of dequantized W) {lms:.4f} ms  "
                  f"bound {bms:.5f} ms  max|err| {err:.3g}")
            layer["ms"] += ms
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
    print(f"stream_matmul, one layer's 7 matmuls at M=8: kernel "
          f"{layer['ms']:.4f} ms  plain {layer['plain_ms']:.4f} ms  "
          f"library {layer['library_ms']:.4f} ms  bound {bms:.5f} ms "
          f"({by}; {step_bytes:.0f} B with the {layer['table_bytes']} B "
          f"of tables over {n_layers} layers, {layer['flops']} f32 FLOPs); "
          f"cold-L2 bound {cold:.5f} ms ({cold_by}; tables read on every "
          f"call)")
    return {"max_abs_err": max_err, "ms": layer["ms"],
            "plain_ms": layer["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": layer["library_ms"]}


def check_stream_attention(cfg, rng, dev) -> dict:
    """B=4, smax=256, H=9, Hkv=3, hd=64, int3, ragged positions."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kvcache import PackedKVCache
    from repro_torch.kvcache import stream_attention as sa

    b, smax, bits = 4, 256, 3
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kvc = PackedKVCache.create(cfg, bits=bits, page_tokens=8, n_slots=b,
                               max_seq=smax, n_layers=1, device=dev)
    slots = torch.arange(b, device=dev)
    for t in range(smax):
        k = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        v = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        kvc.append(k.to(dev), v.to(dev), torch.full((b,), t, device=dev),
                   slots, layer=0)
    pos = torch.tensor([255, 191, 127, 63], device=dev)
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
        raise AssertionError(f"stream_attention: max |err| {err:.3g}")
    ms = time_ms(lambda: sa.stream_attention(*args, bits=bits))
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
    n_tok = pos.cpu().numpy().astype(np.int64) + 1
    # the K/V offset tables serve every layer: read once per decode step
    tab_bytes = int(n_tok.max()) * hkv * (hd + 1) * 4 * 2
    nbytes = (q.numel() * 2 + b * 8 + q.numel() * 2
              + int(n_tok.sum()) * hkv * (-(-hd * bits // 8) + 2) * 2)
    flops = int(n_tok.sum()) * h * hd * 4
    bms, by = bound_ms(nbytes + tab_bytes / cfg.n_layers, flops)
    cold, cold_by = bound_ms(nbytes + tab_bytes, flops)
    print(f"stream_attention B={b} smax={smax} H={h} Hkv={hkv} hd={hd} "
          f"int{bits} pos={pos.tolist()}: kernel {ms:.4f} ms  plain "
          f"{pms:.4f} ms  library(sdpa on dense_kv) {lms:.4f} ms  bound "
          f"{bms:.6f} ms ({by}; {tab_bytes} B of tables over "
          f"{cfg.n_layers} layers); cold-L2 bound {cold:.6f} ms "
          f"({cold_by})  max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": lms}


def decode_check(cfg, tree, rng, dev) -> None:
    """``DECODE_STEPS`` teacher-forced decode steps through the kernels.
    Each step is also taken through the plain versions over the packed KV
    pages that the kernels' step wrote (the plain step appends nothing),
    and the two steps' logits must agree within ``LOGIT_ULPS`` bf16 ulps
    of the largest logit.  Slot i joins at step i, so rows, M and
    positions are ragged and attention runs over up to ``DECODE_STEPS``
    cached tokens.

    A third run takes the same tokens through the plain versions on a
    cache of its own.  How far it drifts from the kernels' run is
    printed, not checked: a last-bit difference in an f32 sum can move an
    int3 KV code by a whole step, and later steps attend over it."""
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
    adapter = PackedAdapter(cfg, tree, kv="packed", kv_bits=3)
    toks = rng.integers(1, cfg.vocab_size, (DECODE_STEPS, b))
    state = adapter.init_state(b, 256)
    free = adapter.init_state(b, 256)
    ulps, drift, top, worst, bad = [], 0.0, 0, 0.0, []
    for t in range(DECODE_STEPS):
        active = [i for i in range(b) if t >= i]
        slots = torch.tensor(active, device=dev)
        tok = torch.as_tensor(toks[t, active], device=dev)
        pos = state["pos"]
        got, state = packed_decode_step(cfg, tree, state, tok,
                                        slot_ids=slots, kv="packed")
        want, _ = packed_decode_step(cfg, tree, read_only(state, pos), tok,
                                     slot_ids=slots, kv="packed", plain=True)
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
    print(f"decode, {DECODE_STEPS} ragged steps, kernels vs plain versions "
          f"over the same KV pages: max|dlogit| per step in bf16 ulps of "
          f"its largest logit {[round(u, 3) for u in ulps]} (tolerance "
          f"{LOGIT_ULPS}; largest logit {worst:.4g}); same top-1 in "
          f"{top}/{n_rows} rows")
    print(f"decode, plain versions on a cache of their own: max|dlogit| "
          f"{drift:.4g} from the kernels' run; "
          f"{int((pages != free_pages).sum())} of {pages.numel()} KV page "
          f"words differ")
    if bad:
        raise AssertionError(f"decode steps {bad}: logits beyond "
                             f"{LOGIT_ULPS} bf16 ulps of the plain run")


def serve(cfg, tree, prompts) -> dict:
    """The main path: Engine over PackedAdapter(kv='packed'), counted."""
    import torch

    from repro_torch.engine import (
        Engine,
        EngineConfig,
        EngineRequest,
        PackedAdapter,
    )
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.kvcache import stream_attention as sa

    engine = Engine(PackedAdapter(cfg, tree, kv="packed", kv_bits=3,
                                  weights="auto"),
                    EngineConfig(batch_size=4, max_seq=256,
                                 max_backlog=None))
    requests = [EngineRequest(uid=uid, prompt=prompt, max_new_tokens=16)
                for uid, prompt in enumerate(prompts)]
    for req in requests:
        engine.submit(req)
    torch.cuda.synchronize()
    sm.launches = 0
    sa.launches = 0
    t0 = time.perf_counter()
    stats = engine.run_until_drained(max_steps=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"stream_matmul": sm.launches, "stream_attention": sa.launches}
    print(f"serve: completed={stats.completed}/{len(prompts)} "
          f"steps={stats.steps} tokens={stats.tokens_generated} "
          f"wall={wall:.3f} s tokens/s={stats.tokens_generated / wall:.2f} "
          f"ms/decode step={wall / max(1, stats.steps) * 1e3:.3f} "
          f"launches={counts}")
    if stats.completed != len(prompts):
        raise AssertionError(f"completed {stats.completed}/{len(prompts)}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    for req in requests:
        if len(req.generated) != 16 or not all(
                0 <= t < cfg.vocab_size for t in req.generated):
            raise AssertionError(f"request {req.uid}: bad tokens "
                                 f"{req.generated}")
    return counts


def profile_steps(cfg, tree, prompts, n_steps: int = 4) -> None:
    """``torch.profiler`` over a few steady engine steps
    (batch 4, packed KV): time by operator, and the device's busy share
    of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import (
        Engine,
        EngineConfig,
        EngineRequest,
        PackedAdapter,
    )

    engine = Engine(PackedAdapter(cfg, tree, kv="packed", kv_bits=3),
                    EngineConfig(batch_size=4, max_seq=256,
                                 max_backlog=None))
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
    print(f"profile: {n_steps} steps in {wall * 1e3:.2f} ms wall "
          f"(profiler on); device busy {dev_us / 1e3:.2f} ms "
          f"({dev_us / 1e4 / wall:.1f}% of wall); "
          f"{launches / n_steps:.0f} kernel launches per step")
    print(events.table(sort_by="self_cpu_time_total", row_limit=18,
                       max_name_column_width=48))
    print(events.table(sort_by=key, row_limit=12, max_name_column_width=48))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.kernels import build
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

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
    cfg = SMOLLM_135M
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    tree = pack_tree(cfg, params, QuantSpec(bits=3, group_size=32),
                     device=dev)
    del params
    tree.stream_words()
    torch.cuda.synchronize()
    print(f"pack: {tree.summary()} in {time.perf_counter() - t0:.2f} s")

    rows = {"stream_matmul": check_stream_matmul(tree, rng, dev),
            "stream_attention": check_stream_attention(cfg, rng, dev)}

    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(2, 6))).tolist()
               for _ in range(8)]
    decode_check(cfg, tree, rng, dev)
    counts = serve(cfg, tree, prompts)
    profile_steps(cfg, tree, prompts)

    meta = {
        "stream_matmul": ("src/repro_torch/csrc/stream_matmul.cu",
                          "src/repro/kernels/stream_matmul.py:183"),
        "stream_attention": ("src/repro_torch/csrc/stream_attention.cu",
                             "src/repro/kvcache/kernels/"
                             "stream_attention.py:99"),
    }
    kernels = []
    for name, row in rows.items():
        src, replaces = meta[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        **row})
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
