"""Nothing the benchmark runs loads JAX or the JAX package: in a fresh
interpreter that runs a cell (trace off and on) and imports every module
of the harness, no loaded module's top-level name is ``jax`` or
``repro`` (``repro_torch`` is the program, and is another name)."""
import pytest

from perfbench.tests.tiny import (
    add_cell,
    copy_benchmark,
    run_fresh,
    tiny_config,
    tiny_mix,
)


@pytest.mark.parametrize("base,trace", [("stablelm-3b-int3", 0),
                                        ("qwen2-vl-2b-int4", 1)])
def test_no_jax_loaded(tmp_path, base, trace):
    root = copy_benchmark(tmp_path)
    kw = {"heads": 6, "kv_heads": 2, "hidden": 96, "ff": 192} \
        if base.startswith("qwen") else {}
    cell = add_cell(root, tiny_config(base, **kw), "tiny4", tiny_mix())
    out = run_fresh(root, cell, trace=trace)
    tops = set(out["modules"])
    assert "repro_torch" in tops and "perfbench" in tops
    for name in ("jax", "jaxlib", "flax", "repro"):
        assert name not in tops, name
