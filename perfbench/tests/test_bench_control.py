"""The control comes out not correct: the reference one precision below the
configuration's (activations kept in fp8 e4m3 where the configuration
keeps bf16), put in the program's place over the same sampled requests
of a run, is judged by the run's own checks at the cell's limits and
fails them, on three seeds of each reduced configuration, while the
program on the same run passes.  (On the chip the same judgement, at the
cells' own sizes and limits, is ``perfbench/calibrate.py``'s.)"""
import time

import pytest

from perfbench import spec
from perfbench.cell import run_cell
from perfbench.tests.tiny import (
    TINY,
    TINY_WINDOW_S,
    add_cell,
    copy_benchmark,
    gap_failed,
    tiny_config,
    tiny_mix,
)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("base", sorted(TINY))
def test_control_breaks_a_limit(tmp_path, base, seed):
    root = copy_benchmark(tmp_path)
    cell = add_cell(root, tiny_config(base, **TINY[base]), "tiny4",
                    tiny_mix(compare=12))
    bench = spec.load_benchmark(root)
    res, _ = run_cell(root, bench, spec.workload(bench, cell), seed=seed,
                      seconds=TINY_WINDOW_S, trace=False, device="cpu",
                      t_start=time.perf_counter(), control=True)
    assert res["correct"] is True, res["checks"]
    assert res["control_correct"] is False, res["control_checks"]
    assert gap_failed(res["control_checks"]), res["control_checks"]
    assert list(res)[-1] == "checks"
