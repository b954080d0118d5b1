"""Layer bundles and the stream-direct exec surface of the port against
the reference: ``pack_bundle`` (buffer bytes, the three metrics rows,
``unpack``), ``serving_stream_report``, ``Plan.stream_tables``,
``Plan.matmul_direct`` / ``LayerStackPlan.matmul_direct`` (the plain
version on the CPU against the reference's Pallas kernel in interpret
mode, ``rtol=1e-5, atol=1e-4``: f32 sums in another order) and the
per-cycle views ``Layout.cycles`` / ``element_positions``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.configs import ARCH_IDS, get_config  # noqa: E402
from repro.core import packing as ref_packing  # noqa: E402
from repro.core import task as ref_task  # noqa: E402
from repro.core.iris import LayoutCache as RefCache  # noqa: E402
from repro.core.iris import schedule as ref_schedule  # noqa: E402
from repro.quant import QuantSpec as RefSpec  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import plan as port_plan  # noqa: E402
from repro_torch.core import layout as port_layout  # noqa: E402
from repro_torch.core import task as port_task  # noqa: E402
from repro_torch.core.iris import LayoutCache, schedule  # noqa: E402
from repro_torch.kernels.stream_matmul import stream_words  # noqa: E402
from repro_torch.quant import QuantSpec  # noqa: E402

BITS = [2, 3, 4, 5, 6, 7, 8]
MM_TOL = dict(rtol=1e-5, atol=1e-4)


def _cfgs(arch="smollm-135m", reduced=True):
    ref, port = get_config(arch), port_configs.get_config(arch)
    return (ref.reduced(), port.reduced()) if reduced else (ref, port)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (truncation), as uint64."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32)
            >> np.uint32(16)).astype(np.uint64)


def _bundle_data(bundle, seed):
    """Seeded codes for the weights, bf16 patterns of positive scales
    and of norm values for the rest."""
    rng = np.random.default_rng(seed)
    data = {}
    for b in bundle:
        if b.name.endswith("_scales"):
            data[b.name] = _bf16_bits(rng.uniform(0.01, 0.1, b.n_elems))
        elif b.width_bits == 16:
            data[b.name] = _bf16_bits(rng.standard_normal(b.n_elems))
        else:
            data[b.name] = rng.integers(0, 1 << b.width_bits, b.n_elems,
                                        dtype=np.uint64)
    return data


def _stacks(bits, *, reduced=True, group_size=32):
    rcfg, pcfg = _cfgs(reduced=reduced)
    ref = ref_api.plan_layer_stack(rcfg, RefSpec(bits=bits,
                                                 group_size=group_size),
                                   n_layers=2, cache=RefCache())
    port = api.plan_layer_stack(pcfg, QuantSpec(bits=bits,
                                                group_size=group_size),
                                n_layers=2, cache=LayoutCache())
    return rcfg, ref, port


def _mats(cfg):
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


# ----------------------------------------------------------------------
# pack_bundle
# ----------------------------------------------------------------------
def _assert_bundles_equal(pb, rb):
    assert pb.problem.canonical_signature() \
        == rb.problem.canonical_signature()
    assert pb.layout.count_intervals == rb.layout.count_intervals
    assert pb.stream_bytes == rb.stream_bytes
    assert np.array_equal(pb.buffer, rb.buffer)
    for row in ("metrics_iris", "metrics_homogeneous", "metrics_padded"):
        assert getattr(pb, row) == getattr(rb, row), row
    assert pb.decode_plan().n_units == rb.decode_plan().n_units
    back, want = pb.unpack(), rb.unpack()
    assert sorted(back) == sorted(want)
    for name in want:
        assert np.array_equal(back[name], np.asarray(want[name])), name


@pytest.mark.parametrize("bits", BITS)
def test_pack_bundle_layer_matches_reference(bits):
    """A reduced smollm layer bundle, norms included, at m=4096 (wide
    scheduling units): the same bytes, rows and decode."""
    _rcfg, ref, port = _stacks(bits)
    data = _bundle_data(port.bundle, bits)
    rb = ref_packing.pack_bundle(list(ref.bundle), data=data,
                                 cache=RefCache())
    pb = port_plan.pack_bundle(list(port.bundle), data=data,
                               cache=LayoutCache())
    _assert_bundles_equal(pb, rb)
    back = pb.unpack()
    for b in port.bundle:
        assert np.array_equal(back[b.name][:b.n_elems], data[b.name])
        assert (back[b.name][b.n_elems:] == 0).all()


@pytest.mark.parametrize("m,spec", [
    (512, [("w", 4, 3000, 1), ("s", 16, 200, 1), ("n", 16, 64, 0)]),
    (4096, [("w", 4, 5000, 1), ("s", 16, 400, 1)]),
    (1024, [("a", 7, 999, 2), ("b", 3, 4097, 0), ("c", 13, 300, 1)]),
])
def test_pack_bundle_small_bundles_match_reference(m, spec):
    rbundle = [ref_packing.BundleTensor(*t) for t in spec]
    pbundle = [port_plan.BundleTensor(*t) for t in spec]
    data = _bundle_data(pbundle, m)
    _assert_bundles_equal(
        port_plan.pack_bundle(pbundle, m=m, data=data, cache=None),
        ref_packing.pack_bundle(rbundle, m=m, data=data, cache=None))
    plan_only = port_plan.pack_bundle(pbundle, m=m, cache=LayoutCache())
    assert plan_only.buffer is None
    with pytest.raises(ValueError, match="without data"):
        plan_only.unpack()


# ----------------------------------------------------------------------
# serving_stream_report
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_stream_report_reduced_matches_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    for bits in BITS:
        for g in (16, 32):
            want = ref_packing.serving_stream_report(
                rcfg, RefSpec(bits=bits, group_size=g), cache=RefCache())
            got = port_plan.serving_stream_report(
                pcfg, QuantSpec(bits=bits, group_size=g),
                cache=LayoutCache())
            assert got == want, (bits, g)


@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8])
def test_serving_stream_report_full_width_smollm(bits):
    """smollm-135m at its published width, group 128 (the explorer's;
    d_model 576 takes 576 // 128 scale rows, as in the reference) and
    group 32."""
    rcfg, pcfg = _cfgs(reduced=False)
    for g in (128, 32):
        want = ref_packing.serving_stream_report(
            rcfg, RefSpec(bits=bits, group_size=g), cache=RefCache())
        got = port_plan.serving_stream_report(
            pcfg, QuantSpec(bits=bits, group_size=g), cache=LayoutCache())
        assert got == want, g


def test_serving_stream_report_agrees_with_the_stack():
    _rcfg, pcfg = _cfgs()
    qspec = QuantSpec(bits=4, group_size=32)
    cache = LayoutCache()
    stack = api.plan_layer_stack(pcfg, qspec, n_layers=1, cache=cache)
    rep = port_plan.serving_stream_report(pcfg, qspec, cache=cache)
    assert rep["iris_MiB_per_layer"] \
        == stack.stream_bytes_per_layer / 2**20
    assert rep["n_decode_units"] == stack.plans[0].decode_plan.n_units
    assert cache.stats["hits"] == 1 and cache.stats["misses"] == 1


# ----------------------------------------------------------------------
# LayerStackPlan over schedule_many
# ----------------------------------------------------------------------
@pytest.mark.parametrize("strategy", ["iris", "homogeneous", "hls_padded"])
def test_layer_stack_strategies_match_reference(strategy):
    rcfg, pcfg = _cfgs()
    ref = ref_api.plan_layer_stack(rcfg, RefSpec(bits=5, group_size=32),
                                   strategy=strategy, cache=RefCache())
    port = api.plan_layer_stack(pcfg, QuantSpec(bits=5, group_size=32),
                                strategy=strategy, cache=LayoutCache())
    assert port.strategy == strategy
    assert port.n_layers == ref.n_layers == rcfg.n_layers
    assert [pl.provenance for pl in port.plans] \
        == [pl.provenance for pl in ref.plans]
    assert [pl.layout.count_intervals for pl in port.plans] \
        == [pl.layout.count_intervals for pl in ref.plans]
    assert port.layouts == tuple(pl.layout for pl in port.plans)
    assert (port.scheduler_runs, port.cache_hits) \
        == (ref.scheduler_runs, ref.cache_hits)
    assert port.provenance == ref.plans[0].provenance
    assert port.b_eff == ref.b_eff
    assert port.stream_bytes_per_layer == ref.stream_bytes_per_layer


def test_plan_layer_stack_is_the_api_entry_point():
    assert api.plan_layer_stack is port_plan.plan_layer_stack
    assert api.LayerStackPlan is port_plan.LayerStackPlan
    for name in ("stream_tables", "matmul_direct"):
        assert callable(getattr(api.LayerStackPlan, name))
        assert callable(getattr(api.Plan, name))


# ----------------------------------------------------------------------
# stream tables and the stream-direct matmul
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bits", BITS)
def test_stream_tables_match_reference(bits):
    rcfg, ref, port = _stacks(bits)
    for name, shape in _mats(rcfg).items():
        rt, pt = ref.stream_tables(name, shape), port.stream_tables(name,
                                                                   shape)
        assert (pt.bits, pt.group_size) == (rt.bits, rt.group_size)
        assert np.array_equal(pt.w_tab, rt.w_tab), name
        assert np.array_equal(pt.s_tab, rt.s_tab), name
        # memoized on the layer's plan
        assert port.stream_tables(name, shape) is pt
    with pytest.raises(KeyError, match="no bundle tensor"):
        port.stream_tables("w_nope", (1, 1))
    with pytest.raises(KeyError, match="no paired scales"):
        port.stream_tables("attn_norm", (1, rcfg.d_model))
    with pytest.raises(ValueError, match="elements"):
        port.stream_tables("wq", (1, 1))


@pytest.mark.parametrize("bits", BITS)
def test_matmul_direct_matches_reference_interpret(bits):
    """Both entry points on the CPU, fed the uint8 rows and the
    ``stream_words`` stream, against the reference's
    ``LayerStackPlan.matmul_direct(interpret=True)`` (the Pallas kernel
    in interpret mode) for wq and w_down, and against the dense product
    of the dequantized weights for all seven matrices."""
    rcfg, ref, port = _stacks(bits)
    data = _bundle_data(port.bundle, 100 + bits)
    buf = port_plan.pack_bundle(list(port.bundle), data=data,
                                cache=LayoutCache()).buffer
    prog = port.exec_program()
    words = stream_words(prog, buf, device="cpu")
    assert words.dtype == torch.int32 and words.device.type == "cpu"
    assert np.array_equal(words.numpy().view(np.uint32),
                          prog.buffer_words32(buf).reshape(-1))
    rng = np.random.default_rng(bits)
    for name, (k, n) in _mats(rcfg).items():
        x = rng.standard_normal((4, k)).astype(np.float32)
        got = port.matmul_direct(torch.from_numpy(x), buf, name, (k, n))
        assert got.dtype == torch.float32 and got.shape == (4, n)
        tabs = port.stream_tables(name, (k, n))
        via_plan = port.plans[1].matmul_direct(
            x, words, name, (k, n), scales=f"{name}_scales",
            group_size=tabs.group_size, elem_widths=port.elem_widths,
            device="cpu")
        assert torch.equal(got, via_plan)
        codes = data[name].astype(np.float64).reshape(k, n)
        sc = (data[f"{name}_scales"].astype(np.uint32) << np.uint32(16)) \
            .view(np.float32).reshape(k // tabs.group_size, n)
        dense = (codes - (1 << (bits - 1))) \
            * np.repeat(sc, tabs.group_size, axis=0)
        np.testing.assert_allclose(got.numpy(), x @ dense, rtol=1e-4,
                                   atol=1e-3)
        if name in ("wq", "w_down"):
            want = np.asarray(ref.matmul_direct(x, buf, name, (k, n)))
            np.testing.assert_allclose(got.numpy(), want, **MM_TOL)


def test_plan_matmul_direct_elementwise_problem_matches_reference():
    """``Plan.matmul_direct`` on a plain (non-bundle) problem, tables at
    the program's own granularity (``elem_widths=None``)."""
    k, n, g, bits = 64, 24, 16, 5
    spec = [("w", bits, k * n, 1), ("w_scales", 16, (k // g) * n, 1)]
    rp, pp = ref_task.make_problem(256, spec), port_task.make_problem(256,
                                                                      spec)
    rpl, ppl = ref_api.plan(rp, cache=None), api.plan(pp, cache=None)
    data = _bundle_data([port_plan.BundleTensor(*t) for t in spec], 7)
    buf = ppl.pack(data)
    assert np.array_equal(buf, rpl.pack(data))
    rt = rpl.stream_tables("w", (k, n), scales="w_scales", group_size=g)
    pt = ppl.stream_tables("w", (k, n), scales="w_scales", group_size=g)
    assert np.array_equal(pt.w_tab, rt.w_tab)
    assert np.array_equal(pt.s_tab, rt.s_tab)
    x = np.random.default_rng(0).standard_normal((3, k)).astype(np.float32)
    want = np.asarray(rpl.matmul_direct(x, buf, "w", (k, n),
                                        scales="w_scales", group_size=g))
    got = ppl.matmul_direct(torch.from_numpy(x), buf, "w", (k, n),
                            scales="w_scales", group_size=g)
    np.testing.assert_allclose(got.numpy(), want, **MM_TOL)
    got_dev = ppl.matmul_direct(x, buf, "w", (k, n), scales="w_scales",
                                group_size=g, device="cpu")
    assert torch.equal(got, got_dev)


# ----------------------------------------------------------------------
# per-cycle views
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["PAPER_EXAMPLE", "INV_HELMHOLTZ"])
def test_cycles_and_element_positions_match_reference(name):
    rl = ref_schedule(getattr(ref_task, name))
    pl = schedule(getattr(port_task, name))
    assert [[dataclasses.astuple(s) for s in segs] for segs in pl.cycles] \
        == [[dataclasses.astuple(s) for s in segs] for segs in rl.cycles]
    assert len(pl.cycles) == pl.c_max
    for i in range(len(pl.problem.arrays)):
        assert pl.element_positions(i) == rl.element_positions(i)
    seg = pl.cycles[0][0]
    assert seg.bits(pl.problem) == seg.n_elems \
        * pl.problem.arrays[seg.array].width
    rebuilt = port_layout.Layout.from_counts(
        pl.problem, [tuple((s.array, s.n_elems) for s in segs)
                     for segs in pl.cycles])
    assert rebuilt.count_intervals == pl.count_intervals
    back = port_layout.Layout.from_counts(
        pl.problem, [tuple((s.array, s.n_elems) for s in segs)
                     for segs in reversed(pl.cycles)], reverse=True)
    assert back.count_intervals == pl.count_intervals


def test_cycles_refuse_large_layouts(monkeypatch):
    lay = schedule(port_task.PAPER_EXAMPLE)
    monkeypatch.setattr(port_layout, "_MATERIALIZE_LIMIT", lay.c_max - 1)
    with pytest.raises(RuntimeError, match="refusing to materialize"):
        lay.cycles
    assert port_layout._MATERIALIZE_LIMIT - 1 < lay.c_max
