"""A run whose timed path is broken reads ``correct`` false.

Each test skips the harness's look for a chip and drives the rest of a
run of a reduced cell on the CPU (``cell.run_cell``: set-up, the loop,
the window, the sample through the reference), with one fault planted
in the program underneath.  A one-chip serving cell can have three of
the faults a run is held against: a step that returns its state
unchanged, half of the batch left out with the mean of the rest in its
place, and a token altered where it is produced.  It has no exchange
between chips to leave out.
"""
import time

import numpy as np
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


def _state_unchanged(monkeypatch):
    from repro_torch.engine.scheduler import PackedAdapter
    from repro_torch.kvcache.cache import PackedKVCache

    real = PackedAdapter.step

    def step(self, state, tokens, active):
        logits, _ = real(self, state, tokens, active)
        return logits, state

    monkeypatch.setattr(PackedAdapter, "step", step)
    monkeypatch.setattr(PackedKVCache, "append", lambda self, *a, **k: self)


def _half_batch(monkeypatch):
    from repro_torch.engine.scheduler import PackedAdapter

    real = PackedAdapter.step

    def step(self, state, tokens, active):
        half = max(1, len(active) // 2)
        logits, state = real(self, state, tokens[:half], list(active)[:half])
        rest = np.repeat(logits.mean(axis=0, keepdims=True),
                         len(active) - half, axis=0)
        return np.concatenate([logits, rest]), state

    monkeypatch.setattr(PackedAdapter, "step", step)


def _token_altered(monkeypatch):
    from repro_torch.engine.scheduler import PackedAdapter

    real = PackedAdapter.step

    def step(self, state, tokens, active):
        logits, state = real(self, state, tokens, active)
        logits = logits.copy()
        logits[0, logits[0].argmax()] = -np.inf      # the first row's token
        return logits, state

    monkeypatch.setattr(PackedAdapter, "step", step)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


def _run(tmp_path, base: str, seed: int) -> dict:
    root = copy_benchmark(tmp_path)
    cell = add_cell(root, tiny_config(base, **TINY[base]), "tiny4",
                    tiny_mix(compare=12))
    bench = spec.load_benchmark(root)
    res, _ = run_cell(root, bench, spec.workload(bench, cell), seed=seed,
                      seconds=TINY_WINDOW_S, trace=False, device="cpu",
                      t_start=time.perf_counter())
    return res


@pytest.mark.parametrize("base", sorted(TINY))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_not_correct(tmp_path, monkeypatch, base, fault):
    FAULTS[fault](monkeypatch)
    res = _run(tmp_path, base, seed=2**31 + 901)
    assert res["correct"] is False, res["checks"]
    assert gap_failed(res["checks"]), res["checks"]


@pytest.mark.parametrize("base", sorted(TINY))
def test_sound_run_reads_correct(tmp_path, base):
    res = _run(tmp_path, base, seed=2**31 + 901)
    assert res["correct"] is True, res["checks"]
