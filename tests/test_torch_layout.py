"""The port's Iris front door and layout kernels against the reference.

Bit-identical: the fused-decode slot tables (``KernelTable``), the host
unpack, the per-slot decode plans, the paper metrics of all four
strategies, the emitted C source, the packed bytes of the fused pack and
the codes of the fused and per-slot decodes (the port's kernels through
their plain versions on the CPU, the reference's Pallas kernels in
interpret mode), the reduced smollm int4 tree's kernel views and streams,
and ``unpack_streams`` round trips.  Inputs are made with numpy from a
seed and handed to both packages.
"""
import dataclasses
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.analysis.suite import DECODE_PROBLEMS, GATE_PROBLEMS  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import exec_plan as ref_exec  # noqa: E402
from repro.core.iris import LayoutCache as RefCache  # noqa: E402
from repro.core.task import make_problem as ref_make_problem  # noqa: E402
from repro.kernels import layout_decode as ref_decode  # noqa: E402
from repro.kernels.layout_pack import pack_layout_fused as ref_pack_fused  # noqa: E402
from repro.kernels.ops import decode_layout as ref_decode_layout  # noqa: E402
from repro.kernels.ref import decode_slot_ref as ref_decode_slot_ref  # noqa: E402
from repro.models.model import Model  # noqa: E402
from repro.quant import QuantSpec as RefSpec  # noqa: E402
from repro.quant import pack_codes_u32 as ref_pack_codes  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core import exec_plan as port_exec  # noqa: E402
from repro_torch.core.iris import LayoutCache as PortCache  # noqa: E402
from repro_torch.core.task import LayoutProblem  # noqa: E402
from repro_torch.kernels import layout_decode, layout_pack  # noqa: E402
from repro_torch.kernels.ops import decode_layout  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.quant import QuantSpec, pack_codes_u32, unpack_codes_u32  # noqa: E402
from repro_torch.tree import pack_tree, unpack_streams  # noqa: E402

STRATEGIES = ["iris", "naive", "homogeneous", "hls_padded"]

#: problems whose pieces straddle u32 words, plus arrays wider than 32
#: bits (up to 64), which the reference packs and decodes on the host and
#: the port's kernels take as two u32 fields
STRADDLE = [
    ("straddle", 96, [("a", 3, 300, 4), ("b", 7, 150, 9), ("c", 11, 90, 2),
                      ("d", 30, 41, 7)]),
    ("host_merge", 128, [("wide", 48, 40, 5), ("narrow", 8, 100, 5)]),
    ("full64", 192, [("w64", 64, 24, 3), ("n5", 5, 70, 3),
                     ("w40", 40, 31, 6)]),
]
WIDE = [ref_make_problem(m, specs) for n, m, specs in STRADDLE
        if n != "straddle"]


def _port_problem(ref_prob) -> LayoutProblem:
    """The same problem, built by the port from the reference's JSON."""
    return LayoutProblem.from_json(ref_prob.to_json())


def _both(ref_prob, strategy="iris"):
    rp = ref_api.plan(ref_prob, strategy, cache=None)
    pp = api.plan(_port_problem(ref_prob), strategy, cache=None)
    return rp, pp


def _codes(prob, seed):
    return api.random_codes(_port_problem(prob), seed=seed)


#: the reference's problems (the port rebuilds each from its JSON)
PROBLEMS = [*GATE_PROBLEMS,
            *(ref_make_problem(m, specs) for _n, m, specs in STRADDLE)]


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_kernel_table_and_programs_bit_identical(i):
    rp, pp = _both(PROBLEMS[i])
    assert pp.layout.count_intervals == rp.layout.count_intervals
    rk, pk = rp.exec_program.kernel, pp.exec_program.kernel
    assert (pk.words32, pk.lanes) == (rk.words32, rk.lanes)
    assert pk.tab.dtype == rk.tab.dtype and np.array_equal(pk.tab, rk.tab)
    assert [i for i, _ in pk.gathers] == [i for i, _ in rk.gathers]
    for (_, g1), (_, g2) in zip(pk.gathers, rk.gathers):
        assert g1.dtype == g2.dtype and np.array_equal(g1, g2)
    assert pp.exec_program.host_arrays == rp.exec_program.host_arrays
    ps, rs = port_exec.pack_kernel_tables(pp.exec_program), \
        ref_exec.pack_kernel_tables(rp.exec_program)
    assert ps[2] == rs[2]
    assert np.array_equal(ps[0], rs[0]) and np.array_equal(ps[1], rs[1])
    if not rp.exec_program.host_arrays:
        # the kernels' tables over u32 fields are the reference's
        sp = port_exec.split_pack_tables(pp.exec_program)
        assert sp[2] == rs[2]
        assert np.array_equal(sp[0], rs[0]) and np.array_equal(sp[1], rs[1])
        tab0, flat0 = port_exec.split_decode_table(pp.exec_program)
        assert np.array_equal(tab0, rk.tab)
        # the general construction gives the same table and indices
        rows, bits, widths = port_exec.split_pieces(pp.exec_program)
        if rows.size:
            lanes, tab, flat = port_exec._slot_table(
                pp.exec_program.c_max, rows, bits, widths)
            assert lanes == rk.lanes and np.array_equal(tab, rk.tab)
            assert np.array_equal(flat, flat0)


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_unpack_compiled_and_decode_plan_bit_identical(i):
    rp, pp = _both(PROBLEMS[i])
    codes = _codes(PROBLEMS[i], seed=i)
    buf = ref_exec.pack_compiled(rp.layout, codes, program=rp.exec_program)
    got = port_exec.unpack_compiled(pp.layout, buf, program=pp.exec_program)
    want = ref_exec.unpack_compiled(rp.layout, buf, program=rp.exec_program)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]) and np.array_equal(got[k],
                                                                 codes[k])
    assert dataclasses.asdict(pp.decode_plan) == \
        dataclasses.asdict(rp.decode_plan)


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_compare_metrics_all_strategies(i):
    want = ref_api.compare(PROBLEMS[i], cache=None)
    got = api.compare(_port_problem(PROBLEMS[i]), cache=None)
    assert list(got) == list(want) == STRATEGIES[1:] + ["iris"]
    for name in STRATEGIES:
        assert dataclasses.asdict(got[name]) == \
            dataclasses.asdict(want[name]), name


def test_paper_example_numbers():
    got = api.compare(api.PAPER_EXAMPLE, cache=None)
    assert [got[s].c_max for s in ("naive", "homogeneous", "hls_padded",
                                   "iris")] == [19, 13, 13, 9]
    assert api.plan(api.PAPER_EXAMPLE, cache=None).render() == \
        ref_api.plan(ref_api.PAPER_EXAMPLE, cache=None).render()


@pytest.mark.parametrize("artifact", ["pack", "decode", "both"])
@pytest.mark.parametrize("which", ["paper", "decode0"])
def test_emitted_c_source_identical(artifact, which):
    ref_prob = ref_api.PAPER_EXAMPLE if which == "paper" \
        else DECODE_PROBLEMS[0]
    rp, pp = _both(ref_prob)
    assert pp.emit("c", artifact=artifact) == rp.emit("c", artifact=artifact)


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
@pytest.mark.parametrize("strategy", ["iris", "homogeneous"])
def test_fused_pack_matches_reference_kernel(i, strategy):
    """Plain ``pack_layout_fused`` (CPU) == the reference's Pallas pack in
    interpret mode == ``pack_compiled``, byte for byte."""
    rp, pp = _both(PROBLEMS[i], strategy)
    codes = _codes(PROBLEMS[i], seed=10 + i)
    with warnings.catch_warnings():         # the reference's host merge
        warnings.simplefilter("ignore")
        want = ref_pack_fused(rp.layout, codes, program=rp.exec_program,
                              interpret=True)
    got = pp.pack(codes, backend="cuda", device="cpu")
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert np.array_equal(got, pp.pack(codes))
    assert np.array_equal(got, pp.pack(codes, compiled=False))


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
@pytest.mark.parametrize("fused", [True, False])
def test_decode_matches_reference_kernels(i, fused):
    """Plain fused / per-slot decode (CPU) == the reference's Pallas
    decode in interpret mode == the input codes."""
    rp, pp = _both(PROBLEMS[i])
    codes = _codes(PROBLEMS[i], seed=20 + i)
    buf = pp.pack(codes)
    with warnings.catch_warnings():         # the reference's host merge
        warnings.simplefilter("ignore")
        want = ref_decode_layout(rp.layout, buf, interpret=True, fused=fused,
                                 program=rp.exec_program if fused else None)
    got = decode_layout(pp.layout, buf, fused=fused,
                        program=pp.exec_program if fused else None,
                        device="cpu")
    assert got.keys() == want.keys()
    for k, v in got.items():
        host = v.numpy()
        assert np.array_equal(host.astype(np.uint64),
                              np.asarray(want[k]).astype(np.uint64)), k
        assert np.array_equal(host.astype(np.uint64), codes[k]), k
    for backend_kw in ({"fused": True}, {"fused": False}):
        out = pp.decode(buf, backend="cuda", device="cpu", **backend_kw)
        assert all(np.array_equal(out[k], codes[k]) for k in codes)


@pytest.mark.parametrize("width", [1, 3, 4, 7, 8, 12, 16, 17, 31, 32])
def test_decode_slot_matches_reference(width):
    rng = np.random.default_rng(width)
    words = 6
    rows = rng.integers(0, 1 << 32, size=(37, words), dtype=np.uint64) \
        .astype(np.uint32)
    offsets = sorted(rng.integers(0, (words - 1) * 32 - width,
                                  size=5).tolist()) + [32 - width // 2]
    want = ref_decode_slot_ref(rows, tuple(offsets), width, 37)
    pallas = np.asarray(ref_decode.decode_slot(
        jnp.asarray(rows), offsets=tuple(offsets), width=width, n_rows=37,
        interpret=True))
    got = layout_decode.decode_slot(
        torch.from_numpy(rows.view(np.int32)),
        torch.tensor(offsets, dtype=torch.int32), width)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(pallas, want)


def test_plain_fused_grid_matches_reference_kernel():
    """The plain fused decode grid against the reference's Pallas grid,
    including empty lanes and full 32-bit fields."""
    rng = np.random.default_rng(5)
    rows, w32, lanes = 24, 5, 128
    words = rng.integers(0, 1 << 32, (rows, w32), dtype=np.uint64) \
        .astype(np.uint32)
    width = rng.integers(0, 33, (rows, lanes)).astype(np.uint32)
    off = rng.integers(0, w32 * 32 - 32, (rows, lanes)).astype(np.uint32)
    tab = np.where(width == 0, 0, off | (width << 20)).astype(np.uint32)
    want = ref_decode._decode_fused_kernel  # run through pallas_call
    from jax.experimental import pallas as pl

    ref_grid = pl.pallas_call(
        want, out_shape=jax.ShapeDtypeStruct((rows, lanes), jnp.uint32),
        interpret=True)(jnp.asarray(words), jnp.asarray(tab))
    got = layout_decode.decode_grid(torch.from_numpy(words.view(np.int32)),
                                    torch.from_numpy(tab.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(ref_grid))


def test_wrappers_never_fall_back():
    meta = torch.device("meta")
    i32 = {"dtype": torch.int32, "device": meta}
    with pytest.raises(ValueError, match="cpu or cuda"):
        layout_pack.pack_words(torch.empty((9,), **i32),
                               torch.empty((2, 4), **i32),
                               torch.empty((2, 4), **i32))
    with pytest.raises(ValueError, match="cpu or cuda"):
        layout_decode.decode_grid(torch.empty((3, 4), **i32),
                                  torch.empty((3, 128), **i32))
    with pytest.raises(ValueError, match="cpu or cuda"):
        layout_decode.decode_slot(torch.empty((3, 4), **i32),
                                  torch.empty((2,), **i32), 5)


def test_entry_points_need_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    pl = api.plan(api.PAPER_EXAMPLE, cache=None)
    codes = api.random_codes(api.PAPER_EXAMPLE, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pl.pack(codes, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pl.decode(pl.pack(codes), backend="cuda")


@pytest.mark.parametrize("i", range(len(WIDE)))
@pytest.mark.parametrize("path", ["pack", "fused", "per_slot"])
def test_wide_arrays_never_take_the_host_path(monkeypatch, i, path):
    """Pieces wider than 32 bits run through the kernels' plain versions
    (two u32 fields each), never through a numpy host pack or unpack, and
    still round-trip bit for bit."""
    rp, pp = _both(WIDE[i])
    assert pp.exec_program.host_arrays
    codes = _codes(WIDE[i], seed=30 + i)
    for a in pp.problem.arrays:
        if a.width == 64:       # the top bit too (random codes leave it 0)
            codes[a.name][::3] |= np.uint64(1 << 63)
    buf = pp.pack(codes)
    assert np.array_equal(buf, ref_exec.pack_compiled(
        rp.layout, codes, program=rp.exec_program))

    def host(*args, **kwargs):
        raise AssertionError("the host path ran")

    for name in ("pack_indexed", "unpack_indexed", "unpack_array",
                 "buffer_words64"):
        monkeypatch.setattr(port_exec.ExecProgram, name, host)
    if path == "pack":
        before = layout_pack.launches
        assert np.array_equal(
            pp.pack(codes, backend="cuda", device="cpu"), buf)
        assert layout_pack.launches == before      # CPU: the plain version
        return
    out = pp.decode(buf, backend="cuda", device="cpu",
                    fused=path == "fused")
    assert all(np.array_equal(out[k], codes[k]) for k in codes)


def test_backend_registry():
    assert api.backends() == ["numpy", "cuda", "c"]
    assert api.strategies() == STRATEGIES[1:] + ["iris"]
    pl = api.plan(api.PAPER_EXAMPLE, cache=None)
    with pytest.raises(KeyError, match="'numpy', 'cuda', 'c'"):
        pl.decode(np.zeros((9, 1), np.uint8), backend="pallas")
    with pytest.raises(NotImplementedError, match="cannot decode"):
        pl.decode(np.zeros((9, 1), np.uint8), backend="c")
    with pytest.raises(NotImplementedError, match="cannot pack"):
        pl.pack({}, backend="c")


def _layer_problem(pkg, cfg, bits=3, g=32, m=4096):
    """One decoder layer's codes and bf16 scales as element arrays
    (the front door's full-width problem, here at reduced width)."""
    specs = []
    for name, (k, n) in _mats(cfg).items():
        specs += [(name, bits, k * n, 0), (f"{name}_scales", 16,
                                           k * n // g, 0)]
    return pkg.make_problem(m, specs)


def _mats(cfg):
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def test_element_layer_problem_front_door():
    """The front door's element-granularity layer problem (reduced
    smollm): same layout as the reference, and numpy / fused / per-slot
    pack and decode agree with the input codes."""
    from repro.core import task as ref_task

    cfg = port_configs.SMOLLM_135M.reduced()
    pp = api.plan(_layer_problem(api, cfg, m=1024), cache=None)
    rp = ref_api.plan(_layer_problem(ref_task, cfg, m=1024), cache=None)
    assert pp.layout.count_intervals == rp.layout.count_intervals
    assert pp.metrics.c_max == rp.metrics.c_max
    codes = api.random_codes(pp.problem, seed=3)
    buf = pp.pack(codes)
    assert np.array_equal(buf, pp.pack(codes, backend="cuda", device="cpu"))
    assert all(s.width <= 32 for s in pp.decode_plan.slots)
    for kw in ({"backend": "numpy"},
               {"backend": "cuda", "device": "cpu"},
               {"backend": "cuda", "device": "cpu", "fused": False}):
        out = pp.decode(buf, **kw)
        assert all(np.array_equal(out[k], codes[k]) for k in codes), kw


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_codes_u32_bit_identical(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, (2, 64, 24)).astype(np.uint8)
    got = pack_codes_u32(torch.from_numpy(codes), bits)
    want = np.stack([np.asarray(ref_pack_codes(jnp.asarray(c), bits))
                     for c in codes])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(unpack_codes_u32(got, bits).numpy(), codes)
    with pytest.raises(ValueError, match="32 % bits"):
        pack_codes_u32(torch.from_numpy(codes[0]), 3)


@pytest.fixture(scope="module")
def int4_trees():
    rcfg = get_config("smollm-135m").reduced()
    pcfg = port_configs.SMOLLM_135M.reduced()
    params = Model(rcfg, remat="none").init(jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, params)
    rt = ref_api.pack_tree(rcfg, params, RefSpec(bits=4, group_size=32),
                           cache=RefCache())
    pt = pack_tree(pcfg, params_from_jax(np_params, device="cpu"),
                   QuantSpec(bits=4, group_size=32), cache=PortCache(),
                   device="cpu")
    return rt, pt


@pytest.mark.parametrize("against", ["reference", "pack_compiled"])
def test_int4_tree_views_and_streams_match_reference(int4_trees, against):
    """``pack_tree`` packs through the fused pack kernel (its plain
    version here): the streams equal the reference's and the host pack
    of the same pieces; the views equal the reference's."""
    rt, pt = int4_trees
    if against == "pack_compiled":
        prog, lay = pt.exec_program(), pt.layout()
        for la in range(pt.n_layers):
            pieces = port_exec.unpack_compiled(lay, pt.streams[la].numpy(),
                                               program=prog)
            assert np.array_equal(
                port_exec.pack_compiled(lay, pieces, program=prog),
                pt.streams[la].numpy()), la
        return
    assert np.array_equal(pt.streams.numpy(), np.asarray(rt.streams))
    assert sorted(pt.packed) == sorted(rt.packed)
    for key, v in rt.packed.items():
        assert np.array_equal(pt.packed[key].numpy().view(np.uint32),
                              np.asarray(v)), key


@pytest.mark.parametrize("bits", [3, 4])
def test_unpack_streams_round_trip(int4_trees, bits):
    from repro.tree import unpack_streams as ref_unpack

    pcfg = port_configs.SMOLLM_135M.reduced()
    if bits == 4:
        pt = int4_trees[1]
    else:
        from repro_torch.models.params import init_params

        pt = pack_tree(pcfg, init_params(pcfg, torch.Generator()
                                         .manual_seed(2), device="cpu"),
                       QuantSpec(bits=3, group_size=32), cache=PortCache(),
                       device="cpu")
    cache = PortCache()
    back = unpack_streams(pt.manifest, pt.streams, pt.other, cache=cache,
                          device="cpu")
    assert back.provenance == "manifest" and cache.misses == 1
    assert torch.equal(back.streams, pt.streams)
    assert sorted(back.scales) == sorted(pt.scales)
    for key, s in pt.scales.items():
        assert torch.equal(back.scales[key].view(torch.int16),
                           s.view(torch.int16)), key
    assert sorted(back.packed) == sorted(pt.packed)
    assert bool(back.packed) == (bits == 4)
    for key, v in pt.packed.items():
        assert torch.equal(back.packed[key], v), key
    again = unpack_streams(pt.manifest, pt.streams.numpy(), pt.other,
                           cache=cache, device="cpu")
    assert again.provenance == "cache-hit"
    if bits == 4:
        # the reference rebuilds the same views from the same bytes
        rt = ref_unpack(int4_trees[0].manifest,
                        np.asarray(int4_trees[0].streams), {},
                        cache=RefCache())
        for key, v in rt.packed.items():
            assert np.array_equal(back.packed[key].numpy().view(np.uint32),
                                  np.asarray(v)), key
