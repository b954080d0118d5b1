"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these skip where
``torch.cuda.is_available()`` is false.  On a machine with an H100 run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

MM_RTOL, MM_ATOL = 1e-4, 1e-4
ATT_ATOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stream_case(bits, k, n, g, dev, seed=0):
    from repro_torch.core.exec_plan import (
        lower_exec,
        pack_compiled,
        stream_matmul_tables,
    )
    from repro_torch.core.iris import schedule
    from repro_torch.core.util import pad_bundle_elements
    from repro_torch.kernels.ref import table_tensor, words_tensor
    from repro_torch.plan import BundleTensor, bundle_problem
    from repro_torch.quant import QuantSpec, bits16, quantize

    rng = np.random.default_rng(seed)
    qt = quantize(torch.from_numpy(rng.standard_normal((k, n), np.float32)),
                  QuantSpec(bits=bits, group_size=g))
    prob = bundle_problem([BundleTensor("w", bits, k * n, 1),
                           BundleTensor("w_scales", 16, (k // g) * n, 1)],
                          m=512)
    lay = schedule(prob)
    prog = lower_exec(lay, elem_widths=(bits, 16))
    data = {"w": qt.codes.numpy().reshape(-1),
            "w_scales": bits16(qt.scales).numpy().reshape(-1)}
    buf = pack_compiled(lay, pad_bundle_elements(prob, prog, data),
                        program=prog)
    tabs = stream_matmul_tables(lay, "w", (k, n), scales="w_scales",
                                group_size=g, program=prog)
    return (words_tensor(prog.buffer_words32(buf).reshape(-1), dev),
            table_tensor(tabs.w_tab, dev), table_tensor(tabs.s_tab, dev))


@pytest.mark.parametrize("bits,m,k,n", [(3, 8, 576, 576), (3, 1, 1536, 576),
                                        (5, 3, 96, 77), (8, 16, 256, 130),
                                        (2, 9, 64, 33)])
def test_stream_matmul_kernel_matches_plain(cuda, bits, m, k, n):
    from repro_torch.kernels import stream_matmul as sm

    words, w_tab, s_tab = _stream_case(bits, k, n, 32, cuda, seed=k + n)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, k), np.float32)).to(cuda)
    before = sm.launches
    got = sm.stream_matmul(x, words, w_tab, s_tab, bits=bits, group_size=32)
    want = sm.stream_matmul_plain(x, words, w_tab, s_tab, bits=bits,
                                  group_size=32)
    torch.cuda.synchronize()
    assert sm.launches == before + 1
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.parametrize("bits,heads,hd,smax", [(3, (9, 3), 64, 256),
                                                (4, (4, 4), 5, 12),
                                                (8, (6, 2), 4, 40)])
def test_stream_attention_kernel_matches_plain(cuda, bits, heads, hd, smax):
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.kvcache import PackedKVCache
    from repro_torch.kvcache import stream_attention as _  # noqa: F401
    import sys

    sa = sys.modules["repro_torch.kvcache.stream_attention"]
    h, hkv = heads
    cfg = SMOLLM_135M.reduced(n_layers=1, n_heads=h, n_kv_heads=hkv,
                              head_dim=hd, d_model=h * hd)
    b = 3
    kvc = PackedKVCache.create(cfg, bits=bits, page_tokens=4, n_slots=b,
                               max_seq=smax, device=cuda)
    rng = np.random.default_rng(bits)
    for t in range(kvc.smax):
        k = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        kvc.append(k.to(cuda), (2 * k).to(cuda), torch.full((b,), t),
                   torch.arange(b), layer=0)
    pos = torch.tensor([kvc.smax - 1, kvc.smax // 2, 0], device=cuda)
    slots = torch.tensor([2, 0, 1], device=cuda)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd), np.float32)) \
        .to(cuda).to(torch.bfloat16)
    tabs = kvc.device_stream_tables()
    args = (kvc.layer_words(0), slots, q, pos, tabs["k"], tabs["k_scales"],
            tabs["v"], tabs["v_scales"])
    got = sa.stream_attention(*args, bits=bits)
    want = sa.stream_attention_plain(*args, bits=bits)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATT_ATOL


@pytest.mark.parametrize("bits,m,k,n", [(4, 8, 576, 576), (4, 8, 1536, 576),
                                        (2, 3, 128, 33), (8, 9, 96, 200)])
def test_packed_matmul_kernel_matches_plain(cuda, bits, m, k, n):
    """Within the stream_matmul tolerance of the plain version, and bit
    for bit equal to stream_matmul over the same codes in an Iris stream
    (both kernels sum in one order)."""
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.quant import QuantSpec, pack_codes_u32, quantize

    rng = np.random.default_rng(k + n)
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32))
    qt = quantize(w, QuantSpec(bits=bits, group_size=32))
    pw = pack_codes_u32(qt.codes, bits).to(cuda)
    sc = qt.scales.to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(cuda)
    before = pm.launches
    got = pm.packed_matmul(x, pw, sc, bits=bits, group_size=32)
    want = pm.packed_matmul_plain(x, pw, sc, bits=bits, group_size=32)
    torch.cuda.synchronize()
    assert pm.launches == before + 1
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)
    words, w_tab, s_tab = _stream_case(bits, k, n, 32, cuda, seed=k + n)
    assert torch.equal(
        got, sm.stream_matmul(x, words, w_tab, s_tab, bits=bits,
                              group_size=32))


def _layout_case(specs, m, seed=0):
    from repro_torch import api
    from repro_torch.core.task import make_problem

    pl = api.plan(make_problem(m, specs), cache=None)
    return pl, api.random_codes(pl.problem, seed=seed)


#: word-straddling widths; arrays wider than 32 bits (two u32 fields
#: each); an element-granularity problem at a full bus
LAYOUT_CASES = {
    "straddle": ([("a", 3, 300, 4), ("b", 7, 150, 9), ("c", 11, 90, 2),
                  ("d", 30, 41, 7)], 96),
    "wide": ([("w64", 64, 24, 3), ("n5", 5, 70, 3), ("w40", 40, 31, 6)],
             192),
    "elements": ([("w", 3, 4096 * 9, 0), ("w_scales", 16, 4096 * 9 // 32, 0),
                  ("v", 4, 3000, 0)], 4096),
}


@pytest.mark.parametrize("specs,m", LAYOUT_CASES.values(),
                         ids=LAYOUT_CASES.keys())
def test_layout_kernels_match_plain(cuda, specs, m):
    """Fused pack, fused decode grid and per-slot decode: bit-equal to
    their plain versions on the card, every array on the kernels, and the
    round trip is exact."""
    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels import layout_pack as lp
    from repro_torch.kernels.ops import buffer_to_u32
    from repro_torch.kernels.ref import words_tensor

    pl, codes = _layout_case(specs, m)
    for a in pl.problem.arrays:
        if a.width == 64:       # the top bit too (random codes leave it 0)
            codes[a.name][::3] |= np.uint64(1 << 63)
    prog = pl.exec_program
    before = (lp.launches, ld.fused_launches)
    buf = pl.pack(codes, backend="cuda")
    assert np.array_equal(buf, pl.pack(codes))
    streams = [torch.from_numpy(codes[a.name].view(np.int64))
               for a in pl.problem.arrays]
    assert torch.equal(
        lp.pack_pieces(prog, [t.to(cuda) for t in streams]).cpu(),
        lp.pack_pieces(prog, streams))
    words = words_tensor(prog.buffer_words32(buf), cuda)
    tab, _ = ld.device_decode_tables(prog, cuda)
    assert torch.equal(ld.decode_grid(words, tab),
                       ld.decode_grid_plain(words, tab))
    rows = buffer_to_u32(torch.from_numpy(buf).to(cuda))
    for slot in [s for s in pl.decode_plan.slots if s.width <= 32][:50]:
        offs = torch.tensor([slot.bit_offset + j * slot.width
                             for j in range(slot.lanes)],
                            dtype=torch.int32, device=cuda)
        slab = rows[slot.start_cycle:slot.start_cycle + slot.n_cycles]
        assert torch.equal(ld.decode_slot(slab, offs, slot.width),
                           ld.decode_slot_plain(slab, offs, slot.width))
    torch.cuda.synchronize()
    for kw in ({"fused": True}, {"fused": False}):
        out = pl.decode(buf, backend="cuda", **kw)
        assert all(np.array_equal(out[k], codes[k]) for k in codes), kw
    assert (lp.launches, ld.fused_launches) == (before[0] + 2,
                                                before[1] + 2)


#: ssd_scan, f32 inputs: f32 sums in another order than the plain
#: version (the reference's own chunked-vs-recurrent bound, 2e-4)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)


def _scan_case(b, t, h, dk, dv, dtype, dev, seed=0, steep=False):
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal((b, t, h, dk), np.float32)
                             * 0.5).to(dev, dtype) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((b, t, h, dv), np.float32)
                         * 0.5).to(dev, dtype)
    w = rng.standard_normal((b, t, h)) * 0.5
    logw = np.full((b, t, h), -60.0) if steep else -np.logaddexp(w, 0.0)
    s0 = torch.from_numpy(rng.standard_normal((b, h, dk, dv), np.float32))
    return q, k, v, torch.from_numpy(logw.astype(np.float32)).to(dev), \
        s0.to(dev)


@pytest.mark.parametrize("b,t,h,dk,dv,chunk,dtype,state", [
    (2, 128, 8, 16, 32, 128, "float32", False),   # reduced jamba widths
    (2, 256, 4, 64, 64, 128, "float32", True),    # full width, state0
    (1, 1000, 3, 64, 64, 128, "float32", True),   # ragged T
    (2, 77, 3, 13, 30, 20, "float32", True),      # odd widths and chunk
    (2, 256, 4, 64, 64, 128, "bfloat16", False),  # the served dtype
])
def test_ssd_scan_kernel_matches_plain(cuda, b, t, h, dk, dv, chunk, dtype,
                                       state):
    from repro_torch.kernels import linear_scan as ls

    td = getattr(torch, dtype)
    q, k, v, logw, s0 = _scan_case(b, t, h, dk, dv, td, cuda, seed=t)
    s0 = s0 if state else None
    before = ls.launches
    got, gs = ls.ssd_scan(q, k, v, logw, chunk=chunk, state0=s0,
                          return_state=True)
    want, ws = ls.ssd_scan_plain(q, k, v, logw, chunk=chunk, state0=s0,
                                 return_state=True)
    torch.cuda.synchronize()
    assert ls.launches == before + 1
    assert got.dtype == td and gs.dtype == torch.float32
    torch.testing.assert_close(gs, ws, **SCAN_TOL)
    if dtype == "float32":
        torch.testing.assert_close(got, want, **SCAN_TOL)
    else:   # one bf16 ulp of the element, plus a floor near 0
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-3)


def test_ssd_scan_kernel_strided_views_and_steep_decay(cuda):
    """q/k as views into one projection (the Mamba layer's layout), and a
    decay of e^-60 per token: the masked triangle takes no overflowing
    exponential, so the output is finite and each token sees itself."""
    from repro_torch.kernels import linear_scan as ls

    b, t, h, n = 2, 192, 4, 16
    rng = np.random.default_rng(3)
    bc = torch.from_numpy(rng.standard_normal((b, t, 2 * h * n),
                                              np.float32)).to(cuda)
    k, q = (a.reshape(b, t, h, n) for a in torch.split(bc, h * n, dim=-1))
    _, _, v, logw, _ = _scan_case(b, t, h, n, 32, torch.float32, cuda,
                                  steep=True)
    got = ls.ssd_scan(q, k, v, logw, chunk=64)
    torch.cuda.synchronize()
    assert not q.is_contiguous() and torch.isfinite(got).all()
    torch.testing.assert_close(got, ls.ssd_scan_plain(q, k, v, logw,
                                                      chunk=64), **SCAN_TOL)
    expect = (q * k).sum(-1, keepdim=True) * v
    torch.testing.assert_close(got, expect, rtol=1e-3, atol=1e-3)
