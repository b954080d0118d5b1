"""One run of one cell: build the served model, run the loop, read the
metrics, check the tokens.

Set-up (counted in ``setup_s``): the seeded weights on the device,
``tree.pack_tree`` (quantize, plan through the layout cache, pack), the
adapter and engine with their packed KV cache, one priming step at the
cell's M (what the program builds on first use), and the warm-up steps
of the running loop.  The loop keeps all slots busy, so every step has
the cell's M, the one shape it uses.  Then the window: the
loop runs for ``seconds``.  With ``trace`` a few more steps run under
the profiler.  Then the program is freed, the weights are made again
from the seed for the reference, and the sampled requests are compared.
"""
from __future__ import annotations

import gc
import sys
import time

from . import spec as specs
from .check import gaps, sample, statistics
from .loop import ClosedLoop
from .record import RunRecord
from .traffic import RequestSource
from .weights import make_weights, port_params

#: steps a ``--trace 1`` run profiles for the device's timeline, and then
#: for the host's operators that label its idle time
TRACE_STEPS = 8
LABEL_STEPS = 4
#: entries of each list of the breakdown
TOP = 10


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def port_config(shape):
    """The program's config for ``shape``; refuses a file whose equations
    the program does not run (it fixes these, it has no option for
    them)."""
    from repro_torch.configs import ModelConfig

    fixed = {"norm_eps == 1e-5": shape.norm_eps == 1e-5,
             "rotary_dim == head_dim": shape.rotary_dim == shape.head_dim,
             "embedding_multiplier == sqrt(hidden_size) in torch_dtype":
                 shape.embedding_is_sqrt_d(),
             "torch_dtype == bfloat16": shape.dtype == "bfloat16",
             "hidden_act == silu": shape.act == "silu",
             "norm in (layernorm, rmsnorm)":
                 shape.norm in ("layernorm", "rmsnorm")}
    bad = [k for k, ok in fixed.items() if not ok]
    if bad:
        raise ValueError(f"{shape.name}: the program runs only {bad}")
    return ModelConfig(
        name=shape.name, family="dense", n_layers=shape.n_layers,
        d_model=shape.d_model, n_heads=shape.n_heads,
        n_kv_heads=shape.n_kv_heads, d_ff=shape.d_ff,
        vocab_size=shape.vocab_size, head_dim=shape.head_dim, act=shape.act,
        norm=shape.norm, use_bias=shape.linear_bias,
        tie_embeddings=shape.tie_word_embeddings, rope_theta=shape.rope_theta,
        mrope_sections=shape.mrope_section, dtype="bfloat16")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(shape, quant: dict, mix: dict, seed: int, device, parts: dict):
    """The served program: returns ``engine_factory(sampler)``."""
    from repro_torch.engine import Engine, EngineConfig, PackedAdapter
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

    cfg = port_config(shape)
    lane = {"lane_packed": True, "stream": False}[quant["weight_path"]]
    t = time.perf_counter()
    weights = make_weights(shape, seed, device)
    _sync(device)
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tree = pack_tree(cfg, port_params(weights),
                     QuantSpec(bits=quant["weight_bits"],
                               group_size=quant["group_size"]),
                     m=quant["stream_m"], with_kernel_views=lane,
                     device=device)
    del weights
    _sync(device)
    parts["pack_tree_s"] = time.perf_counter() - t
    t = time.perf_counter()
    adapter = PackedAdapter(cfg, tree, weights="packed" if lane else "stream",
                            kv="packed", kv_bits=quant["kv_bits"],
                            page_tokens=quant["kv_page_tokens"],
                            kv_m=quant["kv_stream_m"])
    config = EngineConfig(batch_size=mix["clients"], max_seq=mix["max_seq"],
                          max_backlog=None)

    def factory(sampler):
        eng = Engine(adapter, config, sampler=sampler)
        parts["engine_s"] = time.perf_counter() - t
        return eng

    return factory


def judge(conf: dict, mix: dict, got: dict, n_cmp: int
          ) -> tuple[dict, bool]:
    """``(checks, correct)``: each number of the configuration's ``check``
    read from ``got`` beside its limit, and the count of tokens compared
    beside the mix's least."""
    checks = {name: {"value": got[name], "limit": float(limit)}
              for name, limit in conf["check"].items()}
    checks["tokens_compared"] = {"value": n_cmp,
                                 "limit": int(mix["compare_min_tokens"]),
                                 "at_least": True}
    correct = all(c["value"] >= c["limit"] if c.get("at_least")
                  else c["value"] <= c["limit"] for c in checks.values())
    return checks, correct


def run_cell(root, bench: dict, wl: dict, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: bool = False
             ) -> tuple[dict, RunRecord]:
    """Returns ``(result, record)``: the result line's object (the
    ``checks`` key last) and what the run recorded.  ``control`` also
    puts the fp8 control in the program's place over the same sample
    (never in a benchmark run): its numbers go into
    ``result["control"]`` (the limits' upper readings), the run's own
    into ``result["served"]``, and the control is judged by the same
    checks at the cell's limits into ``result["control_checks"]`` and
    ``result["control_correct"]``."""
    import torch

    device = torch.device(device)
    conf = specs.load_config(root, bench, wl["config"])
    mix = specs.load_traffic(root, wl["traffic"])
    shape = specs.ModelShape.from_config(conf)
    quant = conf["quantization"]
    parts: dict = {}
    factory = build(shape, quant, mix, seed, device, parts)
    loop = ClosedLoop(factory, RequestSource(mix, shape.vocab_size, seed),
                      mix["clients"])
    t = time.perf_counter()
    loop.prime()
    _sync(device)
    parts["priming_step_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop.start()
    loop.run_steps(mix["warm_steps"])
    _sync(device)
    parts["warm_steps_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    w0, w1, steps = loop.run_for(seconds)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    tr = None
    if trace:
        from .trace import profile_steps

        tr = profile_steps(loop, TRACE_STEPS, LABEL_STEPS, device)
    logs = list(loop.logs.values())
    run = RunRecord(shape=shape, quant=quant, mix=mix, setup_s=setup_s,
                    w0=w0, w1=w1, steps=steps, requests=logs, trace=tr)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in specs.cell_metrics(bench, wl["name"], kind):
        value = specs.reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    n_tok = sum(s.tokens for s in steps)
    sent = sum(1 for g in logs if run.in_window(g.sent))
    log(f"window {run.window_s:.3f} s: {len(steps)} steps, {n_tok} tokens, "
        f"{sent} requests sent, "
        f"{sum(1 for g in logs if g.done and run.in_window(g.done))} "
        f"completed; peak device memory {peak} B")

    picked = sample(logs, w0, w1, seed, mix["compare_requests"])
    loop.engine = factory = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    weights = make_weights(shape, seed, device)
    read = gaps(shape, quant, weights, picked, control=control)
    served = read["served"]
    del weights
    n_cmp = int(served.numel())
    got = statistics(served)
    log(f"reference over {len(picked)} requests, {n_cmp} served tokens in "
        f"{time.perf_counter() - t:.3f} s")
    checks, correct = judge(conf, mix, got, n_cmp)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": sent, "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        ops: dict[str, float] = {}
        for name, _, dur in tr.device:
            ops[name] = ops.get(name, 0.0) + dur
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[k, v] for k, v in sorted(
                tr.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]]}
    if control:
        low = statistics(read["control"])
        result["served"] = got
        result["control"] = low
        result["control_checks"], result["control_correct"] = judge(
            conf, mix, low, n_cmp)
    result["checks"] = checks
    return result, run
