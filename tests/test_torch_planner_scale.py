"""The port's planner service against the reference: warm-started
re-planning, ``schedule_many`` (dedupe, pool fan-out, serial fallback),
the :class:`LayoutCache` internals and its on-disk tier.

Every case of ``tests/test_planner_scale.py`` runs here on both packages
with the same seeded problems: count runs are held bit-identical, cache
counters equal after the same sequence of calls, and disk entries equal
byte for byte, each package loading the other's.  The pool cases bound
the pool's wall time (``POOL_TIMEOUT_S``) and turn its "pool
unavailable" warning into an error, so a pool that never ran fails.
"""
import json
import warnings

import numpy as np
import pytest

import repro.core.iris as ref_iris
import repro_torch.core.iris as port_iris
from repro.analysis.mutations import corrupt_checkpoint as ref_corrupt
from repro.core import task as ref_task
from repro_torch.analysis.mutations import corrupt_checkpoint as port_corrupt
from repro_torch.core import task as port_task

PKGS = {"ref": (ref_iris, ref_task), "port": (port_iris, port_task)}
#: wall seconds any pool case may take before it counts as failed
POOL_TIMEOUT_S = 120.0


def _dense_problem(task, m=64, n=5, seed=0):
    """A gap-free scheduling instance (as the reference's tests build it),
    so warm starts are applicable."""
    rng = np.random.default_rng(seed)
    arrays = tuple(
        task.ArraySpec(f"a{i}", width=int(rng.integers(2, 9)),
                       depth=int(rng.integers(50, 400)),
                       due=int(rng.integers(1, 40)), max_lanes=None)
        for i in range(n))
    return task.LayoutProblem(m=m, arrays=arrays)


def _with_depth(task, prob, idx, delta):
    arrays = list(prob.arrays)
    a = arrays[idx]
    arrays[idx] = task.ArraySpec(a.name, a.width, a.depth + delta, a.due,
                                 a.max_lanes)
    return task.LayoutProblem(m=prob.m, arrays=tuple(arrays))


def _both(scenario):
    """Run ``scenario(iris, task)`` on both packages; the port's result
    must equal the reference's."""
    ref = scenario(*PKGS["ref"])
    port = scenario(*PKGS["port"])
    assert port == ref
    return port


def _runs(layouts):
    return [lay.count_intervals for lay in layouts]


# ----------------------------------------------------------------------
# incremental warm-start re-planning
# ----------------------------------------------------------------------
def test_warm_start_sub_bit_identical():
    def scenario(iris, task):
        base = _dense_problem(task, seed=1)
        cache = iris.LayoutCache()
        iris.schedule(base, cache=cache)
        out = []
        for delta in (1, 7, -3):
            nxt = _with_depth(task, base, 2, delta)
            warm = iris.schedule(nxt, cache=cache)
            cold = iris.schedule(nxt, cache=None, warm_start=False)
            assert warm.count_intervals == cold.count_intervals, delta
            out.append(warm.count_intervals)
        return out, cache.stats

    _both(scenario)


@pytest.mark.parametrize("kind", ["ins", "del"])
def test_warm_start_ins_del_bit_identical(kind):
    def scenario(iris, task):
        base = _dense_problem(task, seed=2)
        cache = iris.LayoutCache()
        cache.insert(base, False, iris.schedule(base, cache=None))
        arrays = list(base.arrays)
        if kind == "ins":
            arrays.insert(2, task.ArraySpec("new", 4, 120, 10, None))
        else:
            del arrays[3]
        p = task.LayoutProblem(m=base.m, arrays=tuple(arrays))
        warm = iris.schedule(p, cache=cache)
        cold = iris.schedule(p, cache=None, warm_start=False)
        assert warm.count_intervals == cold.count_intervals
        return warm.count_intervals, cache.stats

    _both(scenario)


def test_warm_start_counter_and_chaining():
    """Consecutive one-delta neighbours warm off each other (MRU chain);
    the prefix is provably gap-free (only ``a0`` is ready before R=9)."""
    def scenario(iris, task):
        base = task.make_problem(64, [("a0", 4, 200, 10), ("a1", 8, 60, 1),
                                      ("a2", 2, 150, 1), ("a3", 6, 80, 1)])
        cache = iris.LayoutCache()
        iris.schedule(base, cache=cache)
        out = []
        for i in range(1, 4):
            p = _with_depth(task, base, 1, i)
            warm = iris.schedule(p, cache=cache)
            assert warm.count_intervals == iris.schedule(
                p, cache=None, warm_start=False).count_intervals
            out.append(warm.count_intervals)
        assert cache.warm_starts == 3
        assert cache.stats["warm_starts"] == 3
        return out, cache.stats

    _both(scenario)


def test_warm_start_replay_tables_shared_by_rebind():
    """A warm start leaves replay tables on the new layout; a rebind
    shares them (``Layout._replay_cache``), and a chain off the rebound
    layout still equals a cold run."""
    task = port_task
    base = task.make_problem(64, [("a0", 4, 200, 10), ("a1", 8, 60, 1),
                                  ("a2", 2, 150, 1), ("a3", 6, 80, 1)])
    cache = port_iris.LayoutCache()
    port_iris.schedule(base, cache=cache)
    warm = port_iris.schedule(_with_depth(task, base, 1, 1), cache=cache)
    assert "replay" in warm._replay_cache
    renamed = task.make_problem(64, [("b0", 4, 200, 10), ("b1", 8, 61, 1),
                                     ("b2", 2, 150, 1), ("b3", 6, 80, 1)])
    hit = cache.lookup(renamed)
    assert hit is not warm and hit._replay_cache is warm._replay_cache
    nxt = _with_depth(task, renamed, 1, 1)
    assert port_iris.schedule(nxt, cache=cache).count_intervals \
        == ref_iris.schedule(_with_depth(
            ref_task, ref_task.make_problem(
                64, [("b0", 4, 200, 10), ("b1", 8, 61, 1),
                     ("b2", 2, 150, 1), ("b3", 6, 80, 1)]), 1, 1),
            cache=None, warm_start=False).count_intervals
    assert cache.warm_starts == 2


def test_warm_start_requires_same_bus_width():
    def scenario(iris, task):
        base = _dense_problem(task, seed=4)
        cache = iris.LayoutCache()
        iris.schedule(base, cache=cache)
        wider = task.LayoutProblem(m=base.m * 2, arrays=base.arrays)
        lay = iris.schedule(wider, cache=cache)   # cold: no neighbour
        assert cache.warm_starts == 0
        assert lay.count_intervals \
            == iris.schedule(wider, cache=None).count_intervals
        return lay.count_intervals, cache.stats

    _both(scenario)


def test_warm_start_disabled_flag():
    def scenario(iris, task):
        base = _dense_problem(task, seed=5)
        cache = iris.LayoutCache()
        iris.schedule(base, cache=cache)
        lay = iris.schedule(_with_depth(task, base, 1, 2), cache=cache,
                            warm_start=False)
        assert cache.warm_starts == 0
        return lay.count_intervals, cache.stats

    _both(scenario)


# ----------------------------------------------------------------------
# LayoutCache internals: LRU order, stats counters
# ----------------------------------------------------------------------
def test_lru_eviction_respects_lookup_promotion():
    def scenario(iris, task):
        cache = iris.LayoutCache(maxsize=3)
        probs = [task.make_problem(8, [("a", 2, d, 0)])
                 for d in (3, 4, 5, 6, 7)]
        for p in probs[:3]:
            iris.schedule(p, cache=cache)
        cache.lookup(probs[0])                 # promote p0 over p1, p2
        iris.schedule(probs[3], cache=cache)   # evicts p1 (now LRU)
        iris.schedule(probs[4], cache=cache)   # evicts p2
        found = [cache.lookup(p) is not None for p in
                 (probs[0], probs[3], probs[4], probs[1], probs[2])]
        assert found == [True, True, True, False, False]
        assert len(cache) == 3
        return found, cache.stats

    _both(scenario)


def test_stats_counters_across_schedule_many():
    def scenario(iris, task):
        layers = [task.make_problem(32, [("w", 4, 60, 5)])
                  for _ in range(4)]
        distinct = task.make_problem(32, [("w", 4, 61, 5)])
        cache = iris.LayoutCache()
        out = iris.schedule_many(layers + [distinct], cache=cache,
                                 workers=1)
        s = dict(cache.stats)
        assert s["misses"] == 2 and s["hits"] == 3 and s["size"] == 2
        iris.schedule_many(layers, cache=cache, workers=1)  # all hits
        assert cache.stats["hits"] == 7 and cache.stats["misses"] == 2
        return _runs(out), s, cache.stats

    _both(scenario)


def _serial_reference(probs):
    cache = ref_iris.LayoutCache()
    return _runs(ref_iris.schedule_many(probs, cache=cache, workers=1)), \
        cache.stats


@pytest.mark.parametrize("workers", [2, 4])
def test_stats_parity_serial_vs_pool(monkeypatch, workers):
    """Pooled == serial == the reference's serial run, layouts and
    counters; the pool really ran (its fallback warning is an error)."""
    ref_probs = [_dense_problem(ref_task, seed=s) for s in range(5)] * 2
    probs = [_dense_problem(port_task, seed=s) for s in range(5)] * 2
    want = _serial_reference(ref_probs)
    serial = port_iris.LayoutCache()
    outs_s = port_iris.schedule_many(probs, cache=serial, workers=1)
    assert (_runs(outs_s), serial.stats) == want
    monkeypatch.setattr(port_iris.os, "cpu_count", lambda: 4)
    monkeypatch.setattr(port_iris, "POOL_TIMEOUT_S", POOL_TIMEOUT_S)
    pooled = port_iris.LayoutCache()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        outs_p = port_iris.schedule_many(probs, cache=pooled,
                                         workers=workers)
    assert (_runs(outs_p), pooled.stats) == want


def test_pool_chains_warm_starts_inside_a_worker(monkeypatch):
    """Contiguous near-miss problems of one chunk warm-start each other
    inside the worker; the merged layouts equal cold runs."""
    base = port_task.make_problem(64, [("a0", 4, 200, 10), ("a1", 8, 60, 1),
                                       ("a2", 2, 150, 1), ("a3", 6, 80, 1)])
    probs = [_with_depth(port_task, base, 1, i) for i in range(6)]
    monkeypatch.setattr(port_iris.os, "cpu_count", lambda: 4)
    monkeypatch.setattr(port_iris, "POOL_TIMEOUT_S", POOL_TIMEOUT_S)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        outs = port_iris.schedule_many(probs, cache=port_iris.LayoutCache(),
                                       workers=2)
    rbase = ref_task.make_problem(64, [("a0", 4, 200, 10), ("a1", 8, 60, 1),
                                       ("a2", 2, 150, 1), ("a3", 6, 80, 1)])
    assert _runs(outs) == [
        ref_iris.schedule(_with_depth(ref_task, rbase, 1, i), cache=None,
                          warm_start=False).count_intervals
        for i in range(6)]


def test_pool_failure_falls_back_to_serial(monkeypatch):
    probs = [_dense_problem(port_task, seed=s) for s in range(3)]
    expect = [ref_iris.schedule(_dense_problem(ref_task, seed=s),
                                cache=None).count_intervals
              for s in range(3)]
    monkeypatch.setattr(port_iris.os, "cpu_count", lambda: 4)
    monkeypatch.setattr(port_iris, "_pool_schedule",
                        lambda *a, **k: None)   # pool unavailable
    outs = port_iris.schedule_many(probs, cache=port_iris.LayoutCache(),
                                   workers=2)
    assert _runs(outs) == expect


def test_dying_workers_fall_back_to_serial(monkeypatch):
    """Workers that exit non-zero make the pool warn and schedule
    serially, with the serial counters."""
    probs = [_dense_problem(port_task, seed=s) for s in range(3)]
    want = _serial_reference([_dense_problem(ref_task, seed=s)
                              for s in range(3)])
    monkeypatch.setattr(port_iris.os, "cpu_count", lambda: 4)
    monkeypatch.setattr(port_iris, "POOL_TIMEOUT_S", POOL_TIMEOUT_S)
    monkeypatch.setattr(port_iris, "_WORKER", "import sys; sys.exit(3)")
    cache = port_iris.LayoutCache()
    with pytest.warns(RuntimeWarning, match="pool unavailable"):
        outs = port_iris.schedule_many(probs, cache=cache, workers=2)
    assert (_runs(outs), cache.stats) == want


def test_effective_workers_clamps(monkeypatch):
    cases = [(8, 2), (8, 100), (None, 1), (0, 5), (None, 3), (3, 7)]
    for cores in (1, 4, 16):
        monkeypatch.setattr(port_iris.os, "cpu_count", lambda: cores)
        monkeypatch.setattr(ref_iris.os, "cpu_count", lambda: cores)
        got = [port_iris._effective_workers(w, n) for w, n in cases]
        assert got == [ref_iris._effective_workers(w, n) for w, n in cases]
    assert port_iris._effective_workers(8, 2) <= 2
    assert port_iris._effective_workers(None, 1) == 1
    assert port_iris._effective_workers(0, 5) == 1


# ----------------------------------------------------------------------
# persistent tier
# ----------------------------------------------------------------------
def _entries(path):
    return {p.name: p.read_bytes() for p in sorted(path.glob("*.json"))}


@pytest.mark.parametrize("fill_residual", [False, True])
def test_disk_entries_byte_equal_and_load_across_packages(tmp_path,
                                                          fill_residual):
    dirs = {k: tmp_path / k for k in PKGS}
    lays = {}
    for k, (iris, task) in PKGS.items():
        probs = [_dense_problem(task, seed=s) for s in (7, 8)]
        writer = iris.LayoutCache(cache_dir=dirs[k])
        lays[k] = [iris.schedule(p, cache=writer,
                                 fill_residual=fill_residual).count_intervals
                   for p in probs]
    assert lays["port"] == lays["ref"]
    assert _entries(dirs["port"]) == _entries(dirs["ref"])
    assert len(_entries(dirs["port"])) == 2
    # each package reads the other's entries
    for k, other in (("port", "ref"), ("ref", "port")):
        iris, task = PKGS[k]
        reader = iris.LayoutCache(cache_dir=dirs[other])
        got = [reader.lookup(_dense_problem(task, seed=s),
                             fill_residual=fill_residual).count_intervals
               for s in (7, 8)]
        assert got == lays["ref"]
        assert (reader.disk_hits, reader.hits, reader.misses,
                reader.disk_rejects) == (2, 2, 0, 0)


def test_persistent_roundtrip_fresh_cache(tmp_path):
    def scenario(iris, task):
        d = tmp_path / iris.__name__
        prob = _dense_problem(task, seed=7)
        lay = iris.schedule(prob, cache=iris.LayoutCache(cache_dir=d))
        reader = iris.LayoutCache(cache_dir=d)
        hit = reader.lookup(prob)
        assert hit.count_intervals == lay.count_intervals
        first = dict(reader.stats)
        assert (reader.disk_hits, reader.hits, reader.misses) == (1, 1, 0)
        reader.lookup(prob)        # promoted to memory: no disk read
        assert reader.disk_hits == 1 and reader.hits == 2
        return lay.count_intervals, first, reader.stats

    _both(scenario)


def test_persistent_keys_on_fill_residual(tmp_path):
    def scenario(iris, task):
        d = tmp_path / iris.__name__
        prob = _dense_problem(task, seed=8)
        iris.schedule(prob, cache=iris.LayoutCache(cache_dir=d),
                      fill_residual=True)
        reader = iris.LayoutCache(cache_dir=d)
        miss = reader.lookup(prob, fill_residual=False)
        hit = reader.lookup(prob, fill_residual=True)
        assert miss is None and hit is not None
        return hit.count_intervals, reader.stats

    _both(scenario)


def _entry_path(d):
    paths = list(d.glob("*.json"))
    assert len(paths) == 1
    return paths[0]


def _tamper_coverage_gap(iris, obj):
    corrupt = ref_corrupt if iris is ref_iris else port_corrupt
    mutated, _s, _d = corrupt(
        {"intervals": obj["payload"]["intervals"]},
        np.zeros((1, 1, 8), dtype=np.uint8), "", "coverage-gap")
    obj["payload"]["intervals"] = mutated["intervals"]
    obj["sha256"] = iris.LayoutCache._payload_digest(obj["payload"])
    return json.dumps(obj)


def _tamper_digest(iris, obj):
    obj["payload"]["intervals"][0][0] += 1      # digest now stale
    return json.dumps(obj)


def _tamper_non_canonical(iris, obj):
    obj["payload"]["intervals"][0][1].append([0, 0])   # zero-count slot
    obj["sha256"] = iris.LayoutCache._payload_digest(obj["payload"])
    return json.dumps(obj)


def _tamper_truncate(iris, obj):
    return json.dumps(obj)[:80]


TAMPER = {"digest": _tamper_digest, "coverage-gap": _tamper_coverage_gap,
          "non-canonical": _tamper_non_canonical,
          "truncated": _tamper_truncate}


@pytest.mark.parametrize("kind", sorted(TAMPER))
def test_disk_rejects_tampered_entry(tmp_path, kind):
    """Each rejection of the reference (stale digest, a coverage gap that
    only the analysis gate catches, a zero-count run, truncated JSON):
    ``disk_rejects`` and the other counters equal the reference's, the
    entry is unlinked, and a re-plan is correct."""
    def scenario(iris, task):
        d = tmp_path / iris.__name__
        prob = _dense_problem(task, seed=9 + sorted(TAMPER).index(kind))
        want = iris.schedule(prob, cache=iris.LayoutCache(cache_dir=d))
        path = _entry_path(d)
        path.write_text(TAMPER[kind](iris, json.loads(path.read_text())))
        cache = iris.LayoutCache(cache_dir=d)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert cache.lookup(prob) is None
        assert cache.disk_rejects == 1 and cache.misses == 1
        assert not path.exists(), "rejected entry must be unlinked"
        again = iris.schedule(prob, cache=cache)
        assert again.count_intervals == want.count_intervals
        return again.count_intervals, cache.stats

    _both(scenario)


def test_disk_rejects_signature_mismatch(tmp_path):
    """An entry filed under one key whose payload describes another
    problem is rejected, in both packages alike."""
    def scenario(iris, task):
        d = tmp_path / iris.__name__
        p1 = _dense_problem(task, seed=13)
        p2 = _with_depth(task, p1, 0, 5)
        iris.schedule(p1, cache=iris.LayoutCache(cache_dir=d))
        iris.schedule(p2, cache=iris.LayoutCache(cache_dir=d))
        a, b = sorted(d.glob("*.json"))
        a.write_text(b.read_text())            # a's key, b's payload
        cache = iris.LayoutCache(cache_dir=d)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            one = cache.lookup(p1)
            two = cache.lookup(p2)
        assert cache.disk_rejects == 1
        assert (one is None) != (two is None)
        return one is None, cache.stats

    _both(scenario)


def test_evicted_entry_survives_on_disk(tmp_path):
    def scenario(iris, task):
        cache = iris.LayoutCache(maxsize=1, cache_dir=tmp_path / iris.__name__)
        p1 = _dense_problem(task, seed=14)
        p2 = _with_depth(task, p1, 1, 3)
        lay1 = iris.schedule(p1, cache=cache)
        iris.schedule(p2, cache=cache)        # evicts p1 from memory
        assert len(cache) == 1
        hit = cache.lookup(p1)                # re-promoted from disk
        assert hit.count_intervals == lay1.count_intervals
        assert cache.disk_hits == 1
        return hit.count_intervals, cache.stats

    _both(scenario)


def test_clear_resets_all_counters(tmp_path):
    def scenario(iris, task):
        cache = iris.LayoutCache(cache_dir=tmp_path / iris.__name__)
        prob = _dense_problem(task, seed=15)
        iris.schedule(prob, cache=cache)
        iris.schedule(prob, cache=cache)
        before = dict(cache.stats)
        cache.clear()
        assert cache.stats == {"hits": 0, "misses": 0, "size": 0,
                               "maxsize": 256, "warm_starts": 0,
                               "disk_hits": 0, "disk_rejects": 0}
        return before, cache.stats

    _both(scenario)


# ----------------------------------------------------------------------
# DEFAULT_CACHE env configuration
# ----------------------------------------------------------------------
def test_env_default_cache_size(monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_SIZE", "17")
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    for iris, _task in PKGS.values():
        c = iris._env_default_cache()
        assert c.maxsize == 17 and c.cache_dir is None


def test_env_default_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "layouts"))
    monkeypatch.delenv("REPRO_CACHE_SIZE", raising=False)
    c = port_iris._env_default_cache()
    assert c.maxsize == 512 and c.cache_dir == tmp_path / "layouts"
    port_iris.schedule(_dense_problem(port_task, seed=16), cache=c)
    assert list(c.cache_dir.glob("*.json")), "persistent tier not active"
    # the reference's default cache, built the same way, reads the entry
    r = ref_iris._env_default_cache()
    assert r.lookup(_dense_problem(ref_task, seed=16)) is not None
    assert r.disk_hits == 1


def test_env_default_cache_malformed_size(monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    for raw in ("not-a-number", "-3", "0", ""):
        monkeypatch.setenv("REPRO_CACHE_SIZE", raw)
        assert port_iris._env_default_cache().maxsize \
            == ref_iris._env_default_cache().maxsize == 512


def test_default_cache_is_built_from_the_environment():
    assert isinstance(port_iris.DEFAULT_CACHE, port_iris.LayoutCache)
    assert port_iris.DEFAULT_CACHE.maxsize \
        == port_iris._env_default_cache().maxsize


# ----------------------------------------------------------------------
# DSE sweep through the batch scheduler
# ----------------------------------------------------------------------
def test_sweep_strategies_matches_per_problem_compare():
    from repro import api as ref_api
    from repro_torch.core.dse import sweep_strategies

    probs = [_dense_problem(port_task, seed=s) for s in range(3)]
    swept = sweep_strategies(probs, ("iris",),
                             cache=port_iris.LayoutCache(), workers=1)
    for s, row in zip(range(3), swept):
        ref = ref_api.compare(_dense_problem(ref_task, seed=s),
                              strategies=("iris",), cache=None)
        assert row["iris"].c_max == ref["iris"].c_max
        assert row["iris"].efficiency == ref["iris"].efficiency


def test_sweep_strategies_presolves_into_cache():
    from repro.core.dse import sweep_strategies as ref_sweep
    from repro_torch.core.dse import sweep_strategies

    def run(iris, task, sweep):
        probs = [_dense_problem(task, seed=s) for s in (20, 21)]
        cache = iris.LayoutCache()
        sweep(probs, ("iris",), cache=cache, workers=1)
        # the compare loop ran on cache hits: one miss per signature
        assert cache.misses == len(probs)
        assert cache.hits >= len(probs)
        return cache.stats

    assert run(port_iris, port_task, sweep_strategies) \
        == run(ref_iris, ref_task, ref_sweep)
