"""A later cell is data: a configuration file and a traffic file, named in
``BENCHMARK.json``, and the harness runs it without an edit of a file it
already has."""
import json
import pathlib

from perfbench.tests.tiny import (
    add_cell,
    copy_benchmark,
    run_fresh,
    tiny_config,
    tiny_mix,
)


def _digest(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_and_mix_run_as_files(tmp_path):
    root = copy_benchmark(tmp_path)
    before = _digest(root)
    cell = add_cell(root, tiny_config("qwen2-vl-2b-int4", heads=6,
                                      kv_heads=2, hidden=96, ff=192),
                    "tiny4", tiny_mix())
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "perfbench/configs/tiny-qwen2-vl-2b-int4.json",
        "perfbench/traffic/tiny4.json"}
    out = run_fresh(root, cell)["result"]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == e2e
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["tokens_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    # a metric's reader is found by its name: a new per-layer metric is a
    # new file and an entry
    (root / "perfbench/metrics/rows_per_step.py").write_text(
        "def read(run):\n"
        "    return sum(s.rows for s in run.steps) / len(run.steps)\n")
    bench["per_layer"].append({"name": "rows_per_step", "unit": "rows",
                               "better": "higher", "source": "program_span",
                               "layer": "engine", "moves": "tokens_per_s",
                               "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_fresh(root, cell, trace=1)["result"]
    assert out["metrics"]["rows_per_step"]["value"] == 4.0
    assert "engine_host_ms" in out["metrics"]
    # the CPU has no device trace: its readers find nothing and stay out
    assert "device_idle" not in out["metrics"]
    assert "stream_attention_roofline" not in out["metrics"]
