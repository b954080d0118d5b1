"""A copy of the benchmark with one more configuration and mix, as a
later change would add them: new files and new entries, at a size the
CPU runs in seconds."""
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


#: the reduced sizes of each configuration the CPU tests run
TINY = {"stablelm-3b-int3": {},
        "qwen2-vl-2b-int4": {"hidden": 96, "heads": 6, "kv_heads": 2,
                             "ff": 192}}

#: the limits of the reduced cells, set from CPU readings of
#: ``served_readings`` over seeds 0-2 of each: sound runs read at most
#: 0.0145 (max) and 0.0004 (mean), the fp8 control at least 0.46 and
#: 0.0114
TINY_LIMITS = {"max_logit_gap": 0.1, "mean_logit_gap": 0.003}

#: the window of a reduced run on the CPU: long enough that its sample
#: holds the mix's least count of tokens to compare, also under a loaded
#: host, so a run fails only on what its tokens say
TINY_WINDOW_S = 30.0


def gap_failed(checks: dict) -> bool:
    """Whether a run's checks fail on a gap (and not on too few tokens)."""
    return (checks["tokens_compared"]["value"]
            >= checks["tokens_compared"]["limit"]
            and any(c["value"] > c["limit"] for c in checks.values()
                    if not c.get("at_least")))


def tiny_config(base: str, *, hidden: int = 128, heads: int = 4,
                kv_heads: int = 4, layers: int = 2, ff: int = 256,
                vocab: int = 512) -> dict:
    """``base``'s file at a reduced size (same equations and formats),
    with the reduced cells' limits."""
    conf = json.loads((ROOT / f"perfbench/configs/{base}.json").read_text())
    conf.update(name=f"tiny-{base}", hidden_size=hidden,
                intermediate_size=ff, num_hidden_layers=layers,
                num_attention_heads=heads, num_key_value_heads=kv_heads,
                vocab_size=vocab, embedding_multiplier=torch.tensor(
                    math.sqrt(hidden), dtype=torch.bfloat16).item())
    if "rope_scaling" in conf:
        hd = hidden // heads
        conf["rope_scaling"] = {"type": "mrope",
                                "mrope_section": [hd // 4, hd // 8, hd // 8]}
    conf["check"] = dict(TINY_LIMITS)
    return conf


def tiny_mix(clients: int = 4, compare: int = 6) -> dict:
    lengths = {"dist": "lognormal", "median": 6, "sigma": 0.3, "min": 3,
               "max": 10}
    mix = json.loads((ROOT / "perfbench/traffic/chat64.json").read_text())
    mix.update(clients=clients, max_seq=64, warm_steps=4,
               compare_requests=compare, compare_min_tokens=10,
               prompt_tokens=lengths, output_tokens=dict(lengths))
    return mix


def add_cell(root: pathlib.Path, conf: dict, mix_name: str, mix: dict
             ) -> str:
    """Write ``conf`` and ``mix`` as new files under ``root`` and name them
    in its ``BENCHMARK.json``; returns the new cell's name."""
    (root / f"perfbench/configs/{conf['name']}.json").write_text(
        json.dumps(conf))
    (root / f"perfbench/traffic/{mix_name}.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = f"{conf['name']}.{mix_name}"
    bench["configs"].append({"name": conf["name"], "source": conf["source"],
                             "file": f"perfbench/configs/{conf['name']}.json",
                             "reduced": conf["reduced"], "why": "CPU test"})
    bench["workloads"].append({"name": cell, "config": conf["name"],
                               "traffic": mix_name, "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def copy_benchmark(dst: pathlib.Path) -> pathlib.Path:
    """The benchmark's files, and the program beside them, under ``dst``."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "src").symlink_to(ROOT / "src")
    return dst


RUN = """
import json, sys, time
t0 = time.perf_counter()
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
from perfbench import spec
from perfbench.cell import run_cell
bench = spec.load_benchmark(spec.ROOT)
res, _ = run_cell(spec.ROOT, bench, spec.workload(bench, sys.argv[2]),
                  seed=int(sys.argv[3]), seconds=float(sys.argv[4]),
                  trace=bool(int(sys.argv[5])), device="cpu", t_start=t0)
import perfbench.run, perfbench.calibrate, perfbench.trace
tops = sorted({m.split(".", 1)[0] for m in sys.modules})
print(json.dumps({"result": res, "modules": tops}))
"""


def run_fresh(root: pathlib.Path, cell: str, *, seed: int = 2**31 + 77,
              seconds: float = TINY_WINDOW_S, trace: int = 0) -> dict:
    """Run ``cell`` of the copy at ``root`` on the CPU in a fresh
    interpreter; returns its result and the top-level names of every
    module it loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["REPRO_CACHE_DIR"] = str(root / "build/perfbench/layout_cache")
    out = subprocess.run([sys.executable, "-c", RUN, str(root), cell,
                          str(seed), str(seconds), str(trace)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def served_readings(conf: dict, mix: dict, seed: int, steps: int,
                    capture: bool = False) -> dict:
    """Build ``conf`` on the CPU, run the closed loop ``steps`` steps (a
    fixed amount of work, unlike a timed window), and read the sampled
    requests' numbers and the fp8 control's over the same sample.  With
    ``capture``, also the program's logits rows as its sampler saw them
    and the reference's at the same positions."""
    import numpy as np
    import torch

    from perfbench import check, spec
    from perfbench.cell import build
    from perfbench.loop import ClosedLoop
    from perfbench.reference.model import served_logits
    from perfbench.traffic import RequestSource
    from perfbench.weights import make_weights

    rows: dict[int, list] = {}

    class Capture(ClosedLoop):
        def sample(self, logits_row, request):
            if capture:
                rows.setdefault(request.uid, []).append(
                    np.array(logits_row, dtype=np.float32))
            return super().sample(logits_row, request)

    shape = spec.ModelShape.from_config(conf)
    quant = conf["quantization"]
    dev = torch.device("cpu")
    loop = Capture(build(shape, quant, mix, seed, dev, {}),
                   RequestSource(mix, shape.vocab_size, seed), mix["clients"])
    loop.start()
    loop.run_steps(steps)
    picked = check.sample(list(loop.logs.values()), 0.0, loop.steps[-1].t_end,
                          seed, mix["compare_requests"])
    weights = make_weights(shape, seed, dev)
    g = check.gaps(shape, quant, weights, picked, control=True)
    out = {"served": check.statistics(g["served"]),
           "control": check.statistics(g["control"]),
           "tokens": int(g["served"].numel())}
    if capture:
        out["program"] = [torch.as_tensor(np.stack(rows[p.uid]))
                          for p in picked]
        out["reference"] = served_logits(
            shape, quant, weights, [p.prompt + p.tokens[:-1] for p in picked],
            [len(p.prompt) - 1 for p in picked])
    return out
