"""The port's layout pack, redesigned, against the reference.

A layer's whole pack is one launch (``layout_pack.pack_runs``): each
piece is read straight from its array's own tensor through the program's
run table (``layout_pack.pack_run_table``: runs of consecutive pieces of
one array side by side in one bus row).  On the CPU its plain version
(``kernels.ref.pack_runs_plain``) runs; here it is held byte for byte
against the reference's host ``pack_compiled`` and its Pallas pack in
interpret mode, on every problem of ``test_torch_layout``, with the top
bit of 64-bit pieces set, streams of uint8, int16, int32 and int64, and
streams shorter than their depth.  Also: the run table covers every piece
once at the offsets of ``layout_decode.piece_descriptors``, a reduced
smollm layer packs as the host packs it, nothing on the CPU moves a
launch counter, and the wrappers refuse other devices.  Every comparison
is ``==``: the results are integers.
"""
import dataclasses
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from test_torch_layout import PROBLEMS, WIDE, _both, _codes  # noqa: E402

from repro.core import exec_plan as ref_exec  # noqa: E402
from repro.kernels.layout_pack import pack_layout_fused as ref_pack_fused  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import tree as port_tree  # noqa: E402
from repro_torch.core import exec_plan as port_exec  # noqa: E402
from repro_torch.core.iris import LayoutCache as PortCache  # noqa: E402
from repro_torch.kernels import layout_decode as ld  # noqa: E402
from repro_torch.kernels import layout_pack as lp  # noqa: E402
from repro_torch.kernels.ref import pack_runs_plain  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.quant import QuantSpec  # noqa: E402

#: the narrowest stream type that holds each piece width, or one type for
#: every array that it holds (int64 otherwise)
NARROW = ((8, np.uint8, torch.uint8), (16, np.uint16, torch.int16),
          (32, np.uint32, torch.int32), (64, np.uint64, torch.int64))
DTYPES = {"narrow": None, "int32": 32, "int64": 64}


def _codes_top_bit(prob, seed):
    """Random codes with the top bit set in every third 64-bit piece
    (``random_codes`` leaves it 0)."""
    codes = _codes(prob, seed)
    for a in prob.arrays:
        if a.width == 64:
            codes[a.name][::3] |= np.uint64(1 << 63)
    return codes


def _stream(codes: np.ndarray, width: int, at_least: int | None
            ) -> torch.Tensor:
    """``codes`` (uint64) as the narrowest tensor type of at least
    ``at_least`` bits that holds ``width``-bit pieces, with their bits."""
    for bits, np_t, torch_t in NARROW:
        if bits >= width and (at_least is None or bits >= at_least):
            host = codes.astype(np_t)
            if np_t != np.uint8:
                host = host.view(np.dtype(str(torch_t).split(".")[1]))
            return torch.from_numpy(host.copy())
    raise AssertionError(width)


def _streams(pp, codes, at_least):
    return [_stream(codes[a.name], ew, at_least)
            for a, ew in zip(pp.problem.arrays, pp.exec_program.elem_widths)]


def _expand(table: lp.PackRuns):
    """Every piece of the run table: (array, index, global bit, width)."""
    r = table.runs.numpy().astype(np.int64)
    k = np.concatenate([np.arange(c) for c in r[:, 5]]) if r.size else \
        np.zeros(0, np.int64)
    rid = np.repeat(np.arange(r.shape[0]), r[:, 5])
    gbit = r[rid, 2] * table.words32 * 32 + r[rid, 3] + k * r[rid, 4]
    return r[rid, 0], r[rid, 1] + k, gbit, r[rid, 4]


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_run_table_covers_every_piece_once(i):
    """Each piece is in one run, at the global bit offset and width of its
    ``piece_descriptors`` entry; runs are sorted by row then bit, and
    ``row_start`` indexes them by row."""
    _, pp = _both(PROBLEMS[i])
    prog = pp.exec_program
    table = lp.pack_run_table(prog)
    assert table.runs.dtype == table.row_start.dtype == torch.int32
    arr, idx, gbit, width = _expand(table)
    gid = np.asarray(prog.piece_base)[arr] + idx
    assert np.array_equal(np.sort(gid), np.arange(prog.n_pieces))
    desc = ld.piece_descriptors(prog).astype(np.int64)
    assert np.array_equal(gbit, desc[gid] >> 6)
    assert np.array_equal(width, (desc[gid] & 63) + 1)
    r = table.runs.numpy()
    assert (r[:, 5] > 0).all()
    key = r[:, 2].astype(np.int64) * (1 << 32) + r[:, 3]
    assert (np.diff(key) > 0).all()
    rs = table.row_start.numpy()
    assert rs[0] == 0 and rs[-1] == r.shape[0]
    for row in range(prog.c_max):
        assert (r[rs[row]:rs[row + 1], 2] == row).all()


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pack_matches_reference(i, dtype):
    """``pack_pieces`` on the CPU and ``pack_runs_plain`` == the
    reference's ``pack_compiled`` == its Pallas pack in interpret mode,
    byte for byte, whatever integer type the streams are."""
    rp, pp = _both(PROBLEMS[i])
    codes = _codes_top_bit(PROBLEMS[i], seed=70 + i)
    want = ref_exec.pack_compiled(rp.layout, codes, program=rp.exec_program)
    with warnings.catch_warnings():         # the reference's host merge
        warnings.simplefilter("ignore")
        kernel = ref_pack_fused(rp.layout, codes, program=rp.exec_program,
                                interpret=True)
    assert np.array_equal(np.asarray(kernel), want)
    prog = pp.exec_program
    streams = _streams(pp, codes, DTYPES[dtype])
    got = lp.pack_pieces(prog, streams)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    table = lp.pack_run_table(prog)
    words = pack_runs_plain(table.runs, streams, prog.c_max, prog.words32)
    assert np.array_equal(
        words.numpy().view(np.uint8)[:, :prog.row_bytes], want)


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_short_streams_pack_as_zeros(i):
    """A stream shorter than its array's depth packs its missing pieces as
    0, as the host pack of the zero-padded codes does."""
    rp, pp = _both(PROBLEMS[i])
    codes = _codes_top_bit(PROBLEMS[i], seed=80 + i)
    short = {k: v[:len(v) // 2] for k, v in codes.items()}
    padded = {k: np.concatenate([v, np.zeros(len(codes[k]) - len(v),
                                              np.uint64)])
              for k, v in short.items()}
    want = ref_exec.pack_compiled(rp.layout, padded, program=rp.exec_program)
    for at_least in (None, 64):
        got = lp.pack_pieces(pp.exec_program, _streams(pp, short, at_least))
        assert np.array_equal(got.numpy(), want), at_least


@pytest.mark.parametrize("bits", [3, 4])
def test_smollm_layer_packs_as_the_host_packs(monkeypatch, bits):
    """``pack_tree`` of a reduced smollm at int3 and int4 hands each
    layer's codes (uint8) and bf16 patterns (int32) to ``pack_pieces`` as
    they are; each layer's buffer == the host ``pack_compiled`` of the
    same pieces."""
    handed = []

    def spy(prog, streams):
        handed.append((prog, list(streams)))
        return lp.pack_pieces(prog, streams)

    monkeypatch.setattr(port_tree, "pack_pieces", spy)
    cfg = port_configs.SMOLLM_135M.reduced()
    params = init_params(cfg, torch.Generator().manual_seed(bits),
                         device="cpu")
    pt = port_tree.pack_tree(cfg, params, QuantSpec(bits=bits, group_size=32),
                             cache=PortCache(), device="cpu")
    assert len(handed) == pt.n_layers
    lay = pt.layout()
    names = [a.name for a in lay.problem.arrays]
    for layer, (prog, streams) in enumerate(handed):
        assert prog is pt.exec_program()
        assert {s.dtype for s in streams} == {torch.uint8, torch.int32}
        data = {}
        for name, s, depth in zip(names, streams, prog.piece_depths):
            v = s.reshape(-1).numpy().astype(np.uint64)
            data[name] = np.concatenate([v, np.zeros(depth - len(v),
                                                     np.uint64)])
        want = port_exec.pack_compiled(lay, data, program=prog)
        assert np.array_equal(pt.streams[layer].numpy(), want), layer


def test_wide_pieces_never_take_the_host_path(monkeypatch):
    """Pieces of 33-64 bits go in whole through the run table: neither the
    host pack nor the split into u32 halves runs."""
    _, pp = _both(WIDE[1])
    codes = _codes_top_bit(WIDE[1], seed=5)
    want = pp.pack(codes)

    def host(*args, **kwargs):
        raise AssertionError("the host or split path ran")

    monkeypatch.setattr(port_exec.ExecProgram, "pack_indexed", host)
    monkeypatch.setattr(lp, "split_pack_tables", host)
    prog = dataclasses.replace(pp.exec_program, tables={})
    got = lp.pack_pieces(prog, _streams(pp, codes, 64))
    assert np.array_equal(got.numpy(), want)


def test_cpu_moves_no_counter():
    _, pp = _both(WIDE[0])
    codes = _codes_top_bit(WIDE[0], seed=6)
    prog = pp.exec_program
    before = lp.launches
    streams = _streams(pp, codes, None)
    lp.pack_pieces(prog, streams)
    lp.pack_runs(lp.device_pack_runs(prog, "cpu"), streams)
    pp.pack(codes, backend="cuda", device="cpu")
    assert lp.launches == before


def test_pack_wrappers_never_fall_back():
    meta = torch.device("meta")
    _, pp = _both(PROBLEMS[0])
    prog = pp.exec_program
    streams = [torch.empty((d,), dtype=torch.int64, device=meta)
               for d in prog.piece_depths]
    with pytest.raises(ValueError, match="cpu or cuda"):
        lp.pack_pieces(prog, streams)
    with pytest.raises(ValueError, match="cpu or cuda"):
        lp.pack_runs(lp.pack_run_table(prog).to(meta), streams)


def test_pack_refuses_what_it_cannot_take():
    _, pp = _both(PROBLEMS[0])
    prog = pp.exec_program
    ok = [torch.zeros(d, dtype=torch.int64) for d in prog.piece_depths]
    with pytest.raises(ValueError, match="streams for"):
        lp.pack_pieces(prog, ok[:-1])
    with pytest.raises(ValueError, match="exceed"):
        lp.pack_pieces(prog, [torch.zeros(d + 1, dtype=torch.int64)
                              for d in prog.piece_depths])
    for dtype in (torch.float32, torch.int8):
        with pytest.raises(ValueError, match="dtypes"):
            lp.pack_pieces(prog, [t.to(dtype) for t in ok])
    with pytest.raises(ValueError, match="different devices"):
        lp.pack_runs(lp.pack_run_table(prog),
                     [*ok[:-1], ok[-1].to("meta")])


def test_run_table_refuses_a_piece_across_its_row():
    """A piece that would cross the end of its bus row, or one wider than
    64 bits, cannot be described: the run table raises."""
    _, pp = _both(WIDE[1])
    prog = pp.exec_program
    last = np.argmax(prog.word)
    word, shift = prog.word.copy(), prog.shift.copy()
    word[last] = (word[last] // prog.wpr) * prog.wpr + prog.wpr - 1
    shift[last] = 63
    bad = dataclasses.replace(prog, word=word, shift=shift, tables={})
    with pytest.raises(ValueError, match="crosses the end of its bus row"):
        lp.pack_run_table(bad)
    wide = dataclasses.replace(prog, elem_widths=(65,) * len(
        prog.elem_widths), tables={})
    with pytest.raises(ValueError, match="1 to 64 bits"):
        lp.pack_run_table(wide)


def test_run_table_is_built_once_per_program_and_device():
    _, pp = _both(WIDE[0])
    prog = dataclasses.replace(pp.exec_program, tables={})
    a = lp.device_pack_runs(prog, "cpu")
    assert lp.device_pack_runs(prog, torch.device("cpu")) is a
    assert lp.pack_run_table(prog) is lp.pack_run_table(prog)
