"""The port's two layout-decode kernels, redesigned, against the reference.

The fused decode writes every piece straight into one int64 output from
a per-piece descriptor (``layout_decode.decode_pieces``); the per-slot
decode runs every (interval, slot) unit of a ``DecodePlan`` in one
launch (``layout_decode.decode_units``).  On the CPU their plain
versions run; here they are held bit for bit against the reference's
Pallas decode in interpret mode and against the codes, on every problem
of ``test_torch_layout``, with the top bit of 64-bit pieces set.  Also:
the unit table and the piece descriptors cover every output word once,
uncovered elements read 0, one unit equals ``decode_slot_plain`` of that
unit, and nothing on the CPU moves a launch counter.
"""
import dataclasses
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from test_torch_layout import PROBLEMS, WIDE, _both, _codes  # noqa: E402

from repro.kernels.ops import decode_layout as ref_decode_layout  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import exec_plan as port_exec  # noqa: E402
from repro_torch.kernels import layout_decode as ld  # noqa: E402
from repro_torch.kernels.ops import buffer_to_u32, decode_layout  # noqa: E402
from repro_torch.kernels.ref import U32  # noqa: E402


def _codes_top_bit(prob, seed):
    """Random codes with the top bit set in every third 64-bit piece
    (``random_codes`` leaves it 0)."""
    codes = _codes(prob, seed)
    for a in prob.arrays:
        if a.width == 64:
            codes[a.name][::3] |= np.uint64(1 << 63)
    return codes


def _one_output(out: dict, names) -> bool:
    """The arrays are consecutive views of one tensor, in problem order."""
    vals = [out[n] for n in names]
    base = vals[0].untyped_storage().data_ptr()
    at = vals[0].storage_offset()
    for v in vals:
        if v.untyped_storage().data_ptr() != base or v.storage_offset() != at:
            return False
        at += v.numel()
    return True


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
@pytest.mark.parametrize("fused", [True, False])
def test_decodes_match_reference_and_codes(i, fused):
    rp, pp = _both(PROBLEMS[i])
    codes = _codes_top_bit(PROBLEMS[i], seed=40 + i)
    buf = pp.pack(codes)
    with warnings.catch_warnings():         # the reference's host merge
        warnings.simplefilter("ignore")
        want = ref_decode_layout(rp.layout, buf, interpret=True, fused=fused,
                                 program=rp.exec_program if fused else None)
    got = decode_layout(pp.layout, buf, fused=fused,
                        program=pp.exec_program if fused else None,
                        device="cpu")
    names = [a.name for a in pp.problem.arrays]
    assert list(got) == names and _one_output(got, names)
    for k, v in got.items():
        assert v.dtype == torch.int64
        host = v.numpy().view(np.uint64)
        assert np.array_equal(host, np.asarray(want[k]).astype(np.uint64)), k
        assert np.array_equal(host, codes[k]), k


@pytest.mark.parametrize("i", range(len(WIDE)))
@pytest.mark.parametrize("fused", [True, False])
def test_front_door_decodes_wide_pieces_with_the_top_bit(i, fused):
    _, pp = _both(WIDE[i])
    codes = _codes_top_bit(WIDE[i], seed=60 + i)
    assert any(a.width > 32 for a in WIDE[i].arrays)
    assert all(int(codes[a.name].max()) >> 63 for a in WIDE[i].arrays
               if a.width == 64)
    buf = pp.pack(codes)
    out = pp.decode(buf, backend="cuda", device="cpu", fused=fused)
    assert all(np.array_equal(out[k], codes[k]) for k in codes)
    fields = decode_layout(pp.layout, torch.from_numpy(buf), fused=fused)
    assert all(np.array_equal(fields[k].numpy().view(np.uint64), codes[k])
               for k in codes)


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_unit_table_covers_every_output_word_once(i):
    _, pp = _both(PROBLEMS[i])
    t = ld.unit_table(pp.decode_plan, pp.problem)
    units = t.units.numpy().astype(np.int64)
    pre = t.prefix.numpy().astype(np.int64)
    assert t.n_out == sum(a.depth for a in pp.problem.arrays)
    assert t.n_fields == pre[-1] and np.array_equal(
        np.diff(pre), units[:, 1] * units[:, 7])
    count = np.zeros(2 * t.n_out, dtype=np.int64)
    for u, lo, hi in zip(units, pre[:-1], pre[1:]):
        elem = u[6] + np.arange(hi - lo)
        words = [2 * elem, 2 * elem + 1] if u[5] == 0 \
            else [2 * elem + u[5] - 1]
        for w in words:
            np.add.at(count, w, 1)
    assert (count == 1).all() and t.covers_all
    n_wide = sum(s.width > 32 for s in pp.decode_plan.slots)
    assert units.shape[0] == pp.decode_plan.n_units + n_wide


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_piece_descriptors_cover_every_piece_once(i):
    _, pp = _both(PROBLEMS[i])
    prog = pp.exec_program
    desc = ld.piece_descriptors(prog).astype(np.int64)
    assert desc.shape == (prog.n_pieces,)
    off, width = desc >> 6, (desc & 63) + 1
    rows, bits, _ = port_exec.split_pieces(prog)
    n = prog.n_pieces
    assert np.array_equal(off, rows[:n] * prog.words32 * 32 + bits[:n])
    assert np.array_equal(width, np.repeat(prog.elem_widths,
                                           prog.piece_depths))
    # no two pieces share a bus bit, and none crosses a row
    order = np.argsort(off, kind="stable")
    assert (off[order][:-1] + width[order][:-1] <= off[order][1:]).all()
    row_bits = prog.words32 * 32
    assert (off // row_bits == (off + width - 1) // row_bits).all()
    # 32- and 64-bit descriptors decode the same pieces
    wide = desc.astype(np.uint64)
    codes = _codes_top_bit(PROBLEMS[i], seed=70 + i)
    words = torch.from_numpy(prog.buffer_words32(pp.pack(codes))
                             .view(np.int32).copy())
    a = ld.decode_pieces(words, torch.from_numpy(desc.astype(np.uint32)
                                                 .view(np.int32)))
    b = ld.decode_pieces(words, torch.from_numpy(wide.view(np.int64)))
    assert torch.equal(a, b)
    assert np.array_equal(a.numpy().view(np.uint64), np.concatenate(
        [codes[x.name] for x in pp.problem.arrays]))


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_uncovered_elements_read_zero(i):
    _, pp = _both(PROBLEMS[i])
    codes = _codes_top_bit(PROBLEMS[i], seed=80 + i)
    buf = pp.pack(codes)
    plan = pp.decode_plan
    dropped = plan.slots[len(plan.slots) // 2]
    part = dataclasses.replace(
        plan, slots=tuple(s for s in plan.slots if s is not dropped))
    assert not ld.unit_table(part, pp.problem).covers_all
    out = decode_layout(pp.layout, buf, plan=part, fused=False, device="cpu")
    n = dropped.lanes * dropped.n_cycles
    for name, v in out.items():
        got, want = v.numpy().view(np.uint64), codes[name].copy()
        if name == dropped.name:
            want[dropped.elem_base:dropped.elem_base + n] = 0
        assert np.array_equal(got, want), name


def _slot_plain(rows, s, lo, width):
    offs = torch.tensor([s.bit_offset + lo + j * s.width
                         for j in range(s.lanes)], dtype=torch.int32)
    return ld.decode_slot_plain(rows, offs, width).to(torch.int64) & U32


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_one_unit_equals_decode_slot_plain(i):
    _, pp = _both(PROBLEMS[i])
    buf = pp.pack(_codes_top_bit(PROBLEMS[i], seed=90 + i))
    words = buffer_to_u32(torch.from_numpy(buf))
    plan = pp.decode_plan
    for s in plan.slots[::max(1, len(plan.slots) // 12)]:
        one = dataclasses.replace(plan, slots=(s,))
        out = decode_layout(pp.layout, buf, plan=one, fused=False,
                            device="cpu")
        rows = words[s.start_cycle:s.start_cycle + s.n_cycles]
        if s.width <= 32:
            want = _slot_plain(rows, s, 0, s.width)
        else:
            want = _slot_plain(rows, s, 0, 32) | (
                _slot_plain(rows, s, 32, min(s.width, 64) - 32) << 32)
        n = s.lanes * s.n_cycles
        v = out[s.name]
        assert torch.equal(v[s.elem_base:s.elem_base + n], want)
        assert not v[:s.elem_base].any() and not v[s.elem_base + n:].any()
        assert all(not w.any() for k, w in out.items() if k != s.name)


def test_cpu_moves_no_counter():
    _, pp = _both(WIDE[1])
    codes = _codes_top_bit(WIDE[1], seed=3)
    buf = pp.pack(codes)
    prog = pp.exec_program
    before = (ld.fused_launches, ld.slot_launches)
    words = torch.from_numpy(prog.buffer_words32(buf).view(np.int32).copy())
    ld.decode_pieces(words, ld.device_piece_table(prog, "cpu"))
    ld.decode_grid(words, ld.device_decode_tables(prog, "cpu")[0])
    rows = buffer_to_u32(torch.from_numpy(buf))
    ld.decode_units(rows, ld.device_unit_table(pp.decode_plan, pp.problem,
                                               "cpu"))
    ld.decode_slot(rows, torch.tensor([0, 5], dtype=torch.int32), 5)
    for fused in (True, False):
        out = pp.decode(buf, backend="cuda", device="cpu", fused=fused)
        assert all(np.array_equal(out[k], codes[k]) for k in codes)
    assert (ld.fused_launches, ld.slot_launches) == before


def test_new_wrappers_never_fall_back():
    meta = torch.device("meta")
    i32 = {"dtype": torch.int32, "device": meta}
    with pytest.raises(ValueError, match="cpu or cuda"):
        ld.decode_pieces(torch.empty((3, 4), **i32),
                         torch.empty((7,), **i32))
    _, pp = _both(PROBLEMS[0])
    table = ld.unit_table(pp.decode_plan, pp.problem).to(meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ld.decode_units(torch.empty((table.n_rows, 512), **i32), table)
    with pytest.raises(ValueError, match="rows or bits"):
        ld.decode_units(torch.empty((table.n_rows - 1, 512), **i32), table)


def test_per_slot_path_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    pl = api.plan(api.PAPER_EXAMPLE, cache=None)
    buf = pl.pack(api.random_codes(api.PAPER_EXAMPLE, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_layout(pl.layout, buf, fused=False)


def test_unit_table_is_built_once_per_plan_and_device():
    pl = api.plan(api.INV_HELMHOLTZ, cache=None)
    plan = pl.decode_plan
    t = ld.device_unit_table(plan, pl.problem, "cpu")
    assert ld.device_unit_table(plan, pl.problem, "cpu") is t
    # a plan made from it is another plan, with its own table
    other = dataclasses.replace(plan, slots=plan.slots[1:])
    assert ld.device_unit_table(other, pl.problem, "cpu") is not t
    assert dataclasses.asdict(other) != dataclasses.asdict(plan)


def test_unit_table_refuses_a_slot_past_its_array():
    pl = api.plan(api.PAPER_EXAMPLE, cache=None)
    s = pl.decode_plan.slots[0]
    bad = dataclasses.replace(pl.decode_plan, slots=(dataclasses.replace(
        s, elem_base=pl.problem.arrays[s.array].depth),))
    with pytest.raises(ValueError, match="covers elements"):
        ld.unit_table(bad, pl.problem)
