"""The port's design-space sweeps and layout explorer against the
reference: the rows of ``sweep_strategies``, ``sweep_widths`` (paper
Table 7) and ``sweep_max_lanes`` (paper Table 6) equal the reference's
exactly, cached sweeps equal uncached ones, and
``python -m repro_torch.examples.layout_explorer`` prints the reference
example's output line for line.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

from repro.core import dse as ref_dse
from repro.core import task as ref_task
from repro.core.iris import LayoutCache as RefCache
from repro_torch.core import dse
from repro_torch.core import task as port_task
from repro_torch.core.iris import LayoutCache

ROOT = pathlib.Path(__file__).resolve().parents[1]
LANE_CAPS = [1, 2, 3, 4, None]
WIDTH_PAIRS = [(64, 64), (48, 40), (33, 31), (30, 19), (17, 13)]


@pytest.fixture(autouse=True)
def serial_sweeps(monkeypatch):
    """Sweeps schedule serially here (one core, so ``schedule_many`` runs
    no pool): the reference forks its pool, which a test process full
    of threads should not do.  The pools are held against serial runs in
    ``test_torch_planner_scale.py``; the explorer below runs them."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)


def _metrics(rows):
    return [{k: dataclasses.asdict(v) for k, v in row.items()}
            for row in rows]


@pytest.mark.parametrize("strategies", [None, ("homogeneous", "iris"),
                                        ("naive", "hls_padded")])
def test_sweep_strategies_rows_equal_reference(strategies):
    names = ("PAPER_EXAMPLE", "INV_HELMHOLTZ")
    got = dse.sweep_strategies(
        [getattr(port_task, n) for n in names]
        + [port_task.matmul_problem(33, 31)], strategies,
        cache=LayoutCache(), workers=1)
    want = ref_dse.sweep_strategies(
        [getattr(ref_task, n) for n in names]
        + [ref_task.matmul_problem(33, 31)], strategies,
        cache=RefCache(), workers=1)
    assert _metrics(got) == _metrics(want)
    if strategies is None:
        assert list(got[0]) == ["naive", "homogeneous", "hls_padded",
                                "iris"]
        assert [m.c_max for m in got[0].values()] == [19, 13, 13, 9]


def test_sweep_widths_rows_equal_reference():
    got = dse.sweep_widths(port_task.matmul_problem, WIDTH_PAIRS,
                           cache=LayoutCache())
    assert got == ref_dse.sweep_widths(ref_task.matmul_problem, WIDTH_PAIRS,
                                       cache=RefCache())
    assert [r["widths"] for r in got] == WIDTH_PAIRS
    for r in got:
        assert r["iris_eff"] >= r["naive_eff"] - 1e-12
        assert r["iris_cmax"] <= r["naive_cmax"]
        assert 0 < r["iris_eff"] <= 1


def test_sweep_max_lanes_rows_equal_reference():
    got = dse.sweep_max_lanes(port_task.INV_HELMHOLTZ, LANE_CAPS,
                              cache=LayoutCache())
    assert got == ref_dse.sweep_max_lanes(ref_task.INV_HELMHOLTZ, LANE_CAPS,
                                          cache=RefCache())
    # paper Table 6: widening the cap only helps density
    for lo, hi in zip(got, got[1:]):
        assert hi["eff"] >= lo["eff"] - 1e-12
        assert hi["cmax"] <= lo["cmax"] and hi["lmax"] <= lo["lmax"]
    assert got[-1]["cmax"] == 696 and got[0]["fifo"] == 0


def test_cached_sweeps_equal_uncached():
    pairs = WIDTH_PAIRS[:3]
    assert dse.sweep_widths(port_task.matmul_problem, pairs,
                            cache=LayoutCache()) \
        == dse.sweep_widths(port_task.matmul_problem, pairs, cache=None)
    cached = dse.sweep_max_lanes(port_task.INV_HELMHOLTZ, LANE_CAPS,
                                 cache=LayoutCache())
    assert cached == dse.sweep_max_lanes(port_task.INV_HELMHOLTZ, LANE_CAPS,
                                         cache=None)
    # a second pass over a warm cache is identical, and all hits
    cache = LayoutCache()
    first = dse.sweep_max_lanes(port_task.INV_HELMHOLTZ, LANE_CAPS,
                                cache=cache)
    misses = cache.misses
    assert dse.sweep_max_lanes(port_task.INV_HELMHOLTZ, LANE_CAPS,
                               cache=cache) == first
    assert cache.misses == misses and cache.hits >= len(LANE_CAPS)


def test_sweep_cache_counters_equal_reference():
    def run(sweep, task, cache):
        sweep(task.INV_HELMHOLTZ, LANE_CAPS, cache=cache)
        sweep(task.INV_HELMHOLTZ, [2, 4, None], cache=cache)
        return cache.stats

    assert run(dse.sweep_max_lanes, port_task, LayoutCache()) \
        == run(ref_dse.sweep_max_lanes, ref_task, RefCache())


def test_layout_explorer_prints_the_reference_output():
    """Both explorers run as their users run them, side by side, in fresh
    processes, with their pools."""
    env = {k: v for k, v in os.environ.items() if k != "REPRO_CACHE_DIR"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    cmds = {"port": [sys.executable, "-m",
                     "repro_torch.examples.layout_explorer",
                     "--arch", "smollm-135m"],
            "ref": [sys.executable, str(ROOT / "examples" /
                                        "layout_explorer.py"),
                    "--arch", "smollm-135m"]}
    procs = {k: subprocess.Popen(c, env=env, cwd=ROOT, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    out = {}
    for k, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, (k, stderr)
        out[k] = stdout.splitlines()
    assert out["port"] == out["ref"]
    assert len(out["port"]) == 30
