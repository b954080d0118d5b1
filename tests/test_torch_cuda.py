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


def _pack_stream(codes, pats, bits, k, n, g, dev):
    """An Iris stream of ``codes`` (k * n, ``bits`` wide) and bf16 scale
    patterns ``pats`` ((k / g) * n), with its offset tables on ``dev``."""
    from repro_torch.core.exec_plan import (
        lower_exec,
        pack_compiled,
        stream_matmul_tables,
    )
    from repro_torch.core.iris import schedule
    from repro_torch.core.util import pad_bundle_elements
    from repro_torch.kernels.ref import table_tensor, words_tensor
    from repro_torch.plan import BundleTensor, bundle_problem

    prob = bundle_problem([BundleTensor("w", bits, k * n, 1),
                           BundleTensor("w_scales", 16, (k // g) * n, 1)],
                          m=512)
    lay = schedule(prob)
    prog = lower_exec(lay, elem_widths=(bits, 16))
    buf = pack_compiled(lay, pad_bundle_elements(
        prob, prog, {"w": codes, "w_scales": pats}), program=prog)
    tabs = stream_matmul_tables(lay, "w", (k, n), scales="w_scales",
                                group_size=g, program=prog)
    return (words_tensor(prog.buffer_words32(buf).reshape(-1), dev),
            table_tensor(tabs.w_tab, dev), table_tensor(tabs.s_tab, dev))


def _stream_case(bits, k, n, g, dev, seed=0):
    from repro_torch.quant import QuantSpec, bits16, quantize

    rng = np.random.default_rng(seed)
    qt = quantize(torch.from_numpy(rng.standard_normal((k, n), np.float32)),
                  QuantSpec(bits=bits, group_size=g))
    return _pack_stream(qt.codes.numpy().reshape(-1),
                        bits16(qt.scales).numpy().reshape(-1), bits, k, n, g,
                        dev)


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
                                                (8, (6, 2), 4, 40),
                                                (3, (96, 8), 128, 64)])
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


@pytest.mark.parametrize("bits,m,k,n,g", [
    (4, 8, 576, 576, 32), (4, 8, 1536, 576, 32), (2, 3, 128, 33, 32),
    (8, 9, 96, 200, 32),
    # ragged K: a last chunk of 16 rows (2 a range), of 24 (3 a range),
    # of 12 (ranges 6 and 7 empty); ragged N
    (2, 5, 272, 33, 16), (4, 8, 24, 130, 8), (8, 1, 12, 1, 4),
    (8, 3, 1040, 77, 16)])
def test_packed_matmul_kernel_matches_plain(cuda, bits, m, k, n, g):
    """Within the stream_matmul tolerance of the plain version, and bit
    for bit equal to stream_matmul over the same codes in an Iris stream
    (both kernels sum in one order)."""
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.quant import QuantSpec, pack_codes_u32, quantize

    rng = np.random.default_rng(k + n)
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32))
    qt = quantize(w, QuantSpec(bits=bits, group_size=g))
    pw = pack_codes_u32(qt.codes, bits).to(cuda)
    sc = qt.scales.to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(cuda)
    before = pm.launches
    got = pm.packed_matmul(x, pw, sc, bits=bits, group_size=g)
    want = pm.packed_matmul_plain(x, pw, sc, bits=bits, group_size=g)
    torch.cuda.synchronize()
    assert pm.launches == before + 1
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)
    words, w_tab, s_tab = _stream_case(bits, k, n, g, cuda, seed=k + n)
    assert torch.equal(
        got, sm.stream_matmul(x, words, w_tab, s_tab, bits=bits,
                              group_size=g))


#: (K, N) of smollm-135m's seven matrices: wq, wk, wv, wo, gate, up, down
SMOLLM_MATS = [(576, 576), (576, 192), (576, 192), (576, 576),
               (576, 1536), (576, 1536), (1536, 576)]


@pytest.mark.parametrize("k,n", SMOLLM_MATS)
def test_packed_matmul_kernel_smollm_shapes(cuda, k, n):
    """int4 at smollm's seven shapes and M = 1, 4, 8 (the cluster split's
    grids of 144-384 blocks) against the plain version."""
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.quant import QuantSpec, pack_codes_u32, quantize

    rng = np.random.default_rng(k * n)
    qt = quantize(torch.from_numpy(rng.standard_normal((k, n), np.float32)),
                  QuantSpec(bits=4, group_size=32))
    pw, sc = pack_codes_u32(qt.codes, 4).to(cuda), qt.scales.to(cuda)
    for m in (1, 4, 8):
        x = torch.from_numpy(rng.standard_normal((m, k), np.float32)) \
            .to(cuda)
        got = pm.packed_matmul(x, pw, sc, bits=4, group_size=32)
        want = pm.packed_matmul_plain(x, pw, sc, bits=4, group_size=32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)


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
    # wide heads and long chunks: Mamba-2's d_state 128 x head_dim 64,
    # 128 x 128 and 256 x 256 heads, ragged dv, chunk 256
    (2, 512, 4, 128, 64, 256, "float32", True),
    (2, 512, 4, 128, 64, 256, "bfloat16", True),
    (1, 300, 3, 128, 128, 256, "float32", True),
    (1, 256, 2, 128, 128, 128, "bfloat16", False),
    (1, 256, 2, 256, 256, 256, "float32", True),
    (1, 256, 2, 256, 256, 64, "bfloat16", True),
    (1, 200, 2, 256, 100, 256, "bfloat16", False),
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


@pytest.mark.parametrize("n", [16, 128])
def test_ssd_scan_kernel_strided_views_and_steep_decay(cuda, n):
    """q/k as views into one projection (the Mamba layer's layout), and a
    decay of e^-60 per token: the masked triangle takes no overflowing
    exponential, so the output is finite and each token sees itself."""
    from repro_torch.kernels import linear_scan as ls

    b, t, h = 2, 192, 4
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


#: stream_attention: bf16 outputs of f32 sums taken in another order than
#: the plain version: one bf16 ulp of the element, plus a floor near 0
ATT_TOL = dict(rtol=2.0 ** -7, atol=1e-4)


def _attention_cache(bits, h, hkv, hd, smax, dev, seed=0, n_slots=4):
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.kvcache import PackedKVCache

    cfg = SMOLLM_135M.reduced(n_layers=1, n_heads=h, n_kv_heads=hkv,
                              head_dim=hd, d_model=h * hd)
    kvc = PackedKVCache.create(cfg, bits=bits, page_tokens=8,
                               n_slots=n_slots, max_seq=smax, device=dev)
    rng = np.random.default_rng(seed)
    slots = torch.arange(n_slots, device=dev)
    for t in range(kvc.smax):
        k = torch.from_numpy(rng.standard_normal((n_slots, hkv, hd),
                                                 np.float32)).to(dev)
        v = torch.from_numpy(rng.standard_normal((n_slots, hkv, hd),
                                                 np.float32)).to(dev)
        kvc.append(k, v, torch.full((n_slots,), t, device=dev), slots,
                   layer=0)
    return kvc, rng


#: (bits, H, Hkv, hd, smax): smollm-135m's heads; an smax that is not a
#: multiple of the split; rep 1 and 8; hd 128; an odd hd (scalar table
#: loads)
ATT_SPLIT_CASES = [(3, 9, 3, 64, 256), (3, 9, 3, 64, 296),
                   (4, 8, 8, 64, 104), (3, 8, 1, 64, 200),
                   (3, 4, 2, 128, 160), (8, 6, 2, 5, 72),
                   # rep 12 (mistral-large-123b's 96 / 8 heads), rep 9 and
                   # rep 20: two and three groups of 8 query heads a block
                   (3, 24, 2, 128, 256), (4, 12, 1, 128, 136),
                   (3, 18, 2, 64, 96), (8, 20, 1, 5, 64)]


@pytest.mark.parametrize("bits,h,hkv,hd,smax", ATT_SPLIT_CASES)
def test_stream_attention_split_edges(cuda, bits, h, hkv, hd, smax):
    """``pos`` at 0, at each split edge and one either side of it, and at
    smax - 1, four slots a call, with ragged slot ids: the kernel's
    cluster merge against the plain version."""
    from repro_torch.kvcache import stream_attention as sa

    b = 4
    kvc, rng = _attention_cache(bits, h, hkv, hd, smax, cuda, seed=smax)
    smax = kvc.smax
    splits, tpb, _ = sa.attention_launch(b, hkv, h // hkv, hd, smax)
    assert splits > 1 and splits * tpb >= smax
    edges = [j * tpb + d for j in range(1, splits) for d in (-1, 0, 1)]
    want_pos = sorted({0, smax - 1, *[p for p in edges if 0 <= p < smax]})
    want_pos += [smax - 1] * (-len(want_pos) % b)
    tabs = kvc.device_stream_tables()
    slots = torch.tensor([2, 0, 3, 1], device=cuda)
    before = sa.launches
    for i in range(0, len(want_pos), b):
        pos = torch.tensor(want_pos[i:i + b], device=cuda)
        q = torch.from_numpy(rng.standard_normal((b, 1, h, hd), np.float32)) \
            .to(cuda).to(torch.bfloat16)
        args = (kvc.layer_words(0), slots, q, pos, tabs["k"],
                tabs["k_scales"], tabs["v"], tabs["v_scales"])
        got = sa.stream_attention(*args, bits=bits)
        want = sa.stream_attention_plain(*args, bits=bits)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **ATT_TOL,
                                   msg=lambda m: f"pos {pos.tolist()}: {m}")
    assert sa.launches == before + len(want_pos) // b


def _raw_stream_case(bits, k, n, g, dev, seed=0):
    """Random ``bits``-wide codes (any width 1..32) and random positive
    bf16 scale patterns in an Iris stream."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, k * n, dtype=np.uint64)
    scales = rng.uniform(0.25, 2.0, (k // g) * n).astype(np.float32)
    return _pack_stream(codes, (scales.view(np.uint32) >> 16).astype(
        np.uint64), bits, k, n, g, dev)


#: (bits, K, group): K = 32 (one short chunk, 4 rows a range); K = 12 and
#: K = 260 (ranges 6-7 and 4-7 of the last chunk empty); bits 1 and 32
MM_EDGE_CASES = [(b, k, g) for b in (1, 32)
                 for k, g in ((32, 32), (12, 4), (260, 4))]


@pytest.mark.parametrize("bits,k,g", MM_EDGE_CASES)
def test_stream_matmul_kernel_edges(cuda, bits, k, g):
    """N = 1 and M = 1..8 on the edge shapes of the K split, at the
    extreme widths, against the plain version."""
    from repro_torch.kernels import stream_matmul as sm

    words, w_tab, s_tab = _raw_stream_case(bits, k, 1, g, cuda, seed=k)
    rng = np.random.default_rng(bits + k)
    for m in range(1, 9):
        x = torch.from_numpy(rng.standard_normal((m, k), np.float32)) \
            .to(cuda)
        got = sm.stream_matmul(x, words, w_tab, s_tab, bits=bits,
                               group_size=g)
        want = sm.stream_matmul_plain(x, words, w_tab, s_tab, bits=bits,
                                      group_size=g)
        torch.cuda.synchronize()
        # at 32 bits a weight reaches 2^31 x scale and outputs ~1e10: the
        # same tolerance, relative to the largest output
        scale = float(want.abs().max()) if bits == 32 else 1.0
        torch.testing.assert_close(got, want, rtol=MM_RTOL,
                                   atol=MM_ATOL * max(1.0, scale))


@pytest.fixture(scope="module")
def int4_layer():
    """One smollm-135m layer at full width packed at int4 (lane-packed
    views and the Iris stream of the same codes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import dataclasses

    from repro_torch.configs import SMOLLM_135M
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

    dev = torch.device("cuda")
    cfg = dataclasses.replace(SMOLLM_135M, n_layers=1)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    return pack_tree(cfg, params, QuantSpec(bits=4, group_size=32),
                     device=dev)


@pytest.mark.parametrize("key", ["attn/wq", "attn/wk", "attn/wv", "attn/wo",
                                 "mlp/w_gate", "mlp/w_up", "mlp/w_down"])
def test_stream_matmul_bit_equal_to_packed_matmul(cuda, int4_layer, key):
    """The summation contract of csrc/matmul_order.cuh: on one int4 tree
    the stream-direct and the lane-packed kernels give the same bits for
    every smollm matrix at M = 1, 4 and 8 (a block of one row tile) and
    at 9, 64 and 65 (blocks of 64 rows)."""
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm

    tree = int4_layer
    pw, sc = tree.packed[key][0], tree.scales[key][0]
    k = sc.shape[0] * tree.spec.group_size
    rng = np.random.default_rng(k)
    for m in (1, 4, 8, 9, 64, 65):
        x = torch.from_numpy(rng.standard_normal((m, k), np.float32)) \
            .to(cuda)
        before = sm.launches
        streamed = tree.matmul_direct(x, key, 0)
        packed = pm.packed_matmul(x, pw, sc, bits=tree.spec.bits,
                                  group_size=tree.spec.group_size)
        torch.cuda.synchronize()
        assert sm.launches == before + 1
        assert torch.equal(streamed, packed), (key, m)


def _full_width_layer(name: str, bits: int):
    """One layer of ``name`` (stablelm-3b or qwen2-vl-2b) at full width,
    packed at ``bits`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import dataclasses

    from repro_torch.configs import QWEN2_VL_2B, STABLELM_3B
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

    dev = torch.device("cuda")
    base = {"stablelm": STABLELM_3B, "qwen2_vl": QWEN2_VL_2B}[name]
    cfg = dataclasses.replace(base, n_layers=1)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    return pack_tree(cfg, params, QuantSpec(bits=bits, group_size=32),
                     device=dev)


@pytest.fixture(scope="module")
def stablelm_int3_layer():
    """One stablelm-3b layer at full width, int3 (served stream-direct)."""
    return _full_width_layer("stablelm", 3)


@pytest.fixture(scope="module")
def qwen2_vl_int4_layer():
    """One qwen2-vl-2b layer at full width, int4 (lane-packed views and
    the Iris stream of the same codes)."""
    return _full_width_layer("qwen2_vl", 4)


MM_KEYS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_gate",
           "mlp/w_up", "mlp/w_down")


@pytest.mark.parametrize("layer,kernel", [("stablelm_int3_layer", "stream"),
                                          ("qwen2_vl_int4_layer", "stream"),
                                          ("qwen2_vl_int4_layer", "packed")])
def test_matmul_rows_blocks_equal_eight_row_calls(cuda, request, layer,
                                                  kernel):
    """A block of 64 rows gives, bit for bit, what blocks of 8 rows give:
    at every M the output equals the rows of its calls on 8-row slices of
    x (each a block of one row tile), for every matrix of the layer; and
    each launch gathers the weights once for every 64 rows.  At M = 64,
    the served batch, the output is also held to the plain version."""
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm

    tree = request.getfixturevalue(layer)
    mod = sm if kernel == "stream" else pm
    for key in MM_KEYS:
        sc = tree.scales[key][0]
        k = sc.shape[0] * tree.spec.group_size
        if kernel == "stream":
            def mm(x, key=key):
                return tree.matmul_direct(x, key, 0)

            def plain(x, key=key):
                return tree.matmul_direct(x, key, 0, plain=True)
        else:
            pw = tree.packed[key][0]

            def mm(x, pw=pw, sc=sc):
                return pm.packed_matmul(x, pw, sc, bits=tree.spec.bits,
                                        group_size=tree.spec.group_size)

            def plain(x, pw=pw, sc=sc):
                return pm.packed_matmul_plain(
                    x, pw, sc, bits=tree.spec.bits,
                    group_size=tree.spec.group_size)
        rng = np.random.default_rng(k + sc.shape[1])
        for m in (9, 16, 17, 63, 64, 65, 130):
            x = torch.from_numpy(rng.standard_normal((m, k), np.float32)) \
                .to(cuda)
            before = (mod.launches, mod.weight_passes)
            got = mm(x)
            assert (mod.launches, mod.weight_passes) == (
                before[0] + 1, before[1] + -(-m // 64)), (key, m)
            rows = torch.cat([mm(x[i:i + 8]) for i in range(0, m, 8)])
            torch.cuda.synchronize()
            assert mod.weight_passes == before[1] + -(-m // 64) + -(-m // 8)
            assert torch.equal(got, rows), (layer, kernel, key, m)
            if m == 64:
                torch.testing.assert_close(got, plain(x), rtol=MM_RTOL,
                                           atol=MM_ATOL)


def _decode_problem(name):
    """The front door's layer problem (one smollm-135m layer's 7 int3
    matrices and their bf16 scale patterns as 14 element arrays, m 4096:
    2170 decode units), or a problem of ``repro_torch.api`` by name."""
    from repro_torch import api

    if name != "layer":
        return getattr(api, name)
    specs = []
    for mat, (k, n) in zip(("wq", "wk", "wv", "wo", "w_gate", "w_up",
                            "w_down"), SMOLLM_MATS):
        specs += [(mat, 3, k * n, 0), (f"{mat}_scales", 16, k * n // 32, 0)]
    return api.make_problem(4096, specs)


@pytest.mark.parametrize("name", ["layer", "PAPER_EXAMPLE", "INV_HELMHOLTZ"])
def test_decode_kernels_one_launch_each(cuda, name):
    """The fused decode (``decode_pieces``) and the whole-plan per-slot
    decode (``decode_units``): one launch each, bit-equal to their plain
    versions and to the codes (64-bit pieces with the top bit set), the
    fused one with 32- and with 64-bit descriptors; a
    plan with a unit left out reads 0 there; ``decode_slot`` on one unit
    (or a wide unit's low field) still equals its plain version; the front
    door's two decodes are one
    launch each."""
    import dataclasses

    from repro_torch import api
    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels.ops import buffer_to_u32

    prob = _decode_problem(name)
    pl = api.plan(prob, cache=None)
    codes = api.random_codes(prob, seed=1)
    for a in prob.arrays:
        if a.width == 64:
            codes[a.name][::3] |= np.uint64(1 << 63)
    buf = pl.pack(codes)
    prog, plan = pl.exec_program, pl.decode_plan
    want = np.concatenate([codes[a.name] for a in prob.arrays])
    words = torch.from_numpy(prog.buffer_words32(buf).view(np.int32).copy()) \
        .to(cuda)
    rows = buffer_to_u32(torch.from_numpy(buf).to(cuda))
    desc = ld.device_piece_table(prog, cuda)
    table = ld.device_unit_table(plan, prob, cuda)
    before = (ld.fused_launches, ld.slot_launches)
    pieces = ld.decode_pieces(words, desc)
    fields = ld.decode_units(rows, table)
    torch.cuda.synchronize()
    assert (ld.fused_launches, ld.slot_launches) == (before[0] + 1,
                                                     before[1] + 1)
    assert torch.equal(pieces, ld.decode_pieces_plain(words, desc))
    wide = torch.from_numpy(ld.piece_descriptors(prog).astype(np.uint64)
                            .view(np.int64)).to(cuda)
    assert torch.equal(ld.decode_pieces(words, wide), pieces)
    assert torch.equal(fields, ld.decode_units_plain(rows, table))
    assert np.array_equal(pieces.cpu().numpy().view(np.uint64), want)
    assert np.array_equal(fields.cpu().numpy().view(np.uint64), want)
    part = dataclasses.replace(plan, slots=plan.slots[1:])
    gap = ld.unit_table(part, prob).to(cuda)
    assert not gap.covers_all
    assert torch.equal(ld.decode_units(rows, gap),
                       ld.decode_units_plain(rows, gap))
    s = plan.slots[len(plan.slots) // 2]
    offs = torch.tensor([s.bit_offset + j * s.width for j in range(s.lanes)],
                        dtype=torch.int32, device=cuda)
    slab = rows[s.start_cycle:s.start_cycle + s.n_cycles]
    width = min(s.width, 32)            # a wide slot's low u32 field
    assert torch.equal(ld.decode_slot(slab, offs, width),
                       ld.decode_slot_plain(slab, offs, width))
    before = (ld.fused_launches, ld.slot_launches)
    for fused in (True, False):
        out = pl.decode(buf, backend="cuda", fused=fused)
        assert all(np.array_equal(out[k], codes[k]) for k in codes), fused
    assert (ld.fused_launches, ld.slot_launches) == (before[0] + 1,
                                                     before[1] + 1)


def _narrow(codes: np.ndarray, width: int) -> torch.Tensor:
    """uint64 ``codes`` of ``width`` bits as the narrowest tensor type
    that holds them (uint8, int16, int32 or int64), with their bits."""
    for bits, np_t, signed in ((8, np.uint8, np.uint8),
                               (16, np.uint16, np.int16),
                               (32, np.uint32, np.int32),
                               (64, np.uint64, np.int64)):
        if width <= bits:
            return torch.from_numpy(codes.astype(np_t).view(signed).copy())
    raise ValueError(width)


def _words_flat(prog, pieces: list[np.ndarray]) -> np.ndarray:
    """``pack_words``' flat u32 stream of the same pieces: a zero
    sentinel, every piece's low 32 bits in piece order, then the high
    halves of the pieces wider than 32 bits."""
    low = [p.astype(np.uint64) for p in pieces]
    high = [pieces[i].astype(np.uint64) >> np.uint64(32)
            for i in prog.host_arrays]
    return np.concatenate([np.zeros(1, np.uint64), *low, *high]) \
        .astype(np.uint32)


def _pack_words_bytes(prog, pieces, dev) -> torch.Tensor:
    from repro_torch.kernels import layout_pack as lp
    from repro_torch.kernels.ref import words_tensor

    src, scode = lp.device_pack_tables(prog, dev)
    words = lp.pack_words(words_tensor(_words_flat(prog, pieces), dev), src,
                          scode)
    return words.view(torch.uint8).reshape(
        prog.c_max, prog.words32 * 4)[:, :prog.row_bytes]


@pytest.mark.parametrize("specs,m", LAYOUT_CASES.values(),
                         ids=LAYOUT_CASES.keys())
def test_pack_pieces_one_launch_equal_to_plain_and_pack_words(cuda, specs,
                                                              m):
    """The run-table pack: one launch a call, byte-equal to its plain
    version and to ``pack_words`` on the same pieces, with int64 streams
    (64-bit pieces with the top bit set), the narrowest stream types, and
    streams shorter than their depth (the rest packs as 0)."""
    from repro_torch.kernels import layout_pack as lp

    pl, codes = _layout_case(specs, m, seed=3)
    for a in pl.problem.arrays:
        if a.width == 64:
            codes[a.name][::3] |= np.uint64(1 << 63)
    prog = pl.exec_program
    names = [a.name for a in pl.problem.arrays]
    wide = [torch.from_numpy(codes[n].view(np.int64)) for n in names]
    narrow = [_narrow(codes[n], w) for n, w in zip(names, prog.elem_widths)]
    short = [s[:s.numel() // 2] for s in narrow]
    want = pl.pack(codes)
    for what, streams in (("int64", wide), ("narrow", narrow),
                          ("short", short)):
        before = lp.launches
        got = lp.pack_pieces(prog, [s.to(cuda) for s in streams])
        torch.cuda.synchronize()
        assert lp.launches == before + 1, what
        assert torch.equal(got.cpu(), lp.pack_pieces(prog, streams)), what
        if what != "short":
            assert np.array_equal(got.cpu().numpy(), want), what
    assert np.array_equal(
        _pack_words_bytes(prog, [codes[n] for n in names], cuda).cpu()
        .numpy(), want)


def test_pack_pieces_full_width_int4_layer(cuda, int4_layer):
    """One smollm-135m layer at full width and int4: ``pack_pieces`` of
    the layer's pieces (uint8 codes, int32 bf16 patterns, as ``pack_tree``
    hands them over, and as int64) is one launch and equals the layer's
    stream, its plain version and ``pack_words``."""
    from repro_torch.kernels import layout_pack as lp

    tree = int4_layer
    prog = tree.exec_program()
    host = prog.unpack_indexed(tree.streams[0].cpu().numpy())
    pieces = [host[i] for i in range(len(prog.piece_depths))]
    narrow = [_narrow(p, w) for p, w in zip(pieces, prog.elem_widths)]
    assert {s.dtype for s in narrow} == {torch.uint8, torch.int16}
    as_tree = [s.to(torch.int32) if s.dtype == torch.int16 else s
               for s in narrow]
    as_tree = [torch.where(s < 0, s + (1 << 16), s)
               if s.dtype == torch.int32 else s for s in as_tree]
    wide = [torch.from_numpy(p.view(np.int64)) for p in pieces]
    for what, streams in (("as pack_tree", as_tree), ("narrow", narrow),
                          ("int64", wide)):
        dev_streams = [s.to(cuda) for s in streams]
        before = lp.launches
        got = lp.pack_pieces(prog, dev_streams)
        torch.cuda.synchronize()
        assert lp.launches == before + 1, what
        assert torch.equal(got, tree.streams[0]), what
    table = lp.device_pack_runs(prog, cuda)
    plain = lp.pack_runs_plain(table.runs, dev_streams, prog.c_max,
                               prog.words32)
    assert torch.equal(lp.pack_runs(table, dev_streams), plain)
    assert torch.equal(_pack_words_bytes(prog, pieces, cuda),
                       tree.streams[0])


def test_pack_pieces_many_arrays_and_strided_streams(cuda):
    """More arrays than the kernel's small argument table holds (40 > 32,
    the 1024-entry table), and streams that are strided views: one
    launch, byte-equal to the plain version and the host pack."""
    from repro_torch.kernels import layout_pack as lp

    widths = (3, 5, 7, 11, 16, 33, 64, 1)
    specs = [(f"a{i}", widths[i % len(widths)], 20 + 3 * i, i % 6)
             for i in range(40)]
    pl, codes = _layout_case(specs, 256, seed=4)
    for a in pl.problem.arrays:
        if a.width == 64:
            codes[a.name][::3] |= np.uint64(1 << 63)
    prog = pl.exec_program
    names = [a.name for a in pl.problem.arrays]
    wide = [torch.from_numpy(codes[n].view(np.int64)) for n in names]
    strided = [torch.stack([s, s], dim=1)[:, 0] for s in wide]
    assert not strided[0].is_contiguous()
    want = pl.pack(codes)
    for what, streams in (("int64", wide), ("strided", strided)):
        before = lp.launches
        got = lp.pack_pieces(prog, [s.to(cuda) for s in streams])
        torch.cuda.synchronize()
        assert lp.launches == before + 1, what
        assert np.array_equal(got.cpu().numpy(), want), what
        assert torch.equal(got.cpu(), lp.pack_pieces(prog, streams)), what


@pytest.fixture(scope="module")
def int3_stack():
    """Two smollm-135m layers at full width packed at int3 (stream-direct
    serving), with a packed int3 KV cache after 3 decode steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import dataclasses

    from repro_torch.configs import SMOLLM_135M
    from repro_torch.engine import PackedAdapter
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

    dev = torch.device("cuda")
    cfg = dataclasses.replace(SMOLLM_135M, n_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    tree = pack_tree(cfg, params, QuantSpec(bits=3, group_size=32),
                     device=dev)
    adapter = PackedAdapter(cfg, tree, kv="packed", kv_bits=3)
    state = adapter.init_state(4, 64)
    for t in range(3):
        _, state = adapter.step(state, np.array([1 + t, 2, 3, 4]),
                                [0, 1, 2, 3])
    return cfg, tree, state


@pytest.mark.parametrize("which", ["int3+kv", "int4"])
def test_restore_packed_on_the_card_equals_the_tree(cuda, which, int3_stack,
                                                    int4_layer, tmp_path):
    """save_packed -> restore_packed on the card: one decode_layout_fused
    launch a layer, and streams, scales, views, the unquantized leaves
    and the KV pages equal to what was saved, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import layout_decode as ld

    if which == "int4":
        tree, kvc = int4_layer, None
    else:
        _cfg, tree, state = int3_stack
        kvc = state["packed_kv"]
    mgr = CheckpointManager(tmp_path)
    mgr.save_packed(0, tree, kv=kvc)
    assert mgr.verify_packed().ok
    before = ld.fused_launches
    got, _ = mgr.restore_packed()
    torch.cuda.synchronize()
    assert ld.fused_launches == before + tree.n_layers
    assert got.device.type == "cuda"
    assert torch.equal(got.streams, tree.streams)
    for key, v in tree.scales.items():
        assert torch.equal(got.scales[key].view(torch.int16),
                           v.view(torch.int16)), key
    assert sorted(got.packed) == sorted(tree.packed)
    for key, v in tree.packed.items():
        assert torch.equal(got.packed[key], v), key
    for key in ("norm1", "norm2", "final_norm"):
        assert torch.equal(got.other[key]["scale"].view(torch.int16),
                           tree.other[key]["scale"].view(torch.int16))
    assert torch.equal(got.other["embed"].view(torch.int16),
                       tree.other["embed"].view(torch.int16))
    kv = mgr.restore_kv()
    if kvc is None:
        assert kv is None
    else:
        assert kv.provenance == "checkpoint" and kv.device.type == "cuda"
        assert torch.equal(kv.pages, kvc.pages)


def test_uploader_on_the_card_uses_a_side_stream(cuda, int3_stack):
    """The uploader's words on the card equal the resident words; the
    copies run on a stream other than the current one, from pinned host
    memory, and decode through it gives the resident logits bit for
    bit."""
    from repro_torch.engine import StreamUploader
    from repro_torch.models.quantized import packed_decode_step

    cfg, tree, state = int3_stack
    with StreamUploader(tree) as up:
        assert up.device.type == "cuda"
        assert up.stream.cuda_stream != \
            torch.cuda.current_stream().cuda_stream
        assert tree.host_stream_words(0).is_pinned()
        for _lap in range(2):
            for layer in range(tree.n_layers):
                got = up(layer)
                want = tree.layer_stream_words(layer)
                assert got.device.type == "cuda"
                assert got.data_ptr() != want.data_ptr()
                assert torch.equal(got, want), layer
        assert up.sync_fetches == 1
        assert up.prefetch_hits == 2 * tree.n_layers - 1
        toks = torch.tensor([5, 6, 7, 8], device=cuda)
        pos = state["pos"].clone()
        kvc = state["packed_kv"]
        pages = kvc.pages.clone()
        want, _ = packed_decode_step(cfg, tree, state, toks, kv="packed")
        kvc.pages.copy_(pages)
        got, _ = packed_decode_step(cfg, tree, dict(state, pos=pos), toks,
                                    kv="packed", stream_source=up)
        torch.cuda.synchronize()
        kvc.pages.copy_(pages)           # the fixture's cache as it was
    assert torch.equal(got, want)


def test_stream_attention_stablelm_heads(cuda):
    """stablelm-3b's attention: 32 query heads over 32 KV heads (rep 1) of
    head_dim 80, int3, B=4, smax 256, ragged positions."""
    from repro_torch.configs import STABLELM_3B
    from repro_torch.kvcache import PackedKVCache
    from repro_torch.kvcache import stream_attention as _  # noqa: F401
    import dataclasses
    import sys

    sa = sys.modules["repro_torch.kvcache.stream_attention"]
    cfg = dataclasses.replace(STABLELM_3B, n_layers=1)
    b, bits, smax = 4, 3, 256
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert (h, hkv, hd) == (32, 32, 80)
    kvc = PackedKVCache.create(cfg, bits=bits, page_tokens=8, n_slots=b,
                               max_seq=smax, device=cuda)
    rng = np.random.default_rng(80)
    for t in range(smax):
        k = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        v = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        kvc.append(k.to(cuda), v.to(cuda), torch.full((b,), t),
                   torch.arange(b), layer=0)
    pos = torch.tensor([255, 191, 64, 0], device=cuda)
    slots = torch.arange(b, device=cuda)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd), np.float32)) \
        .to(cuda).to(torch.bfloat16)
    tabs = kvc.device_stream_tables()
    args = (kvc.layer_words(0), slots, q, pos, tabs["k"], tabs["k_scales"],
            tabs["v"], tabs["v_scales"])
    before = sa.launches
    got = sa.stream_attention(*args, bits=bits)
    want = sa.stream_attention_plain(*args, bits=bits)
    torch.cuda.synchronize()
    assert sa.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= ATT_ATOL


def test_stablelm_layer_biased_packed_decode_kernels_match_plain(cuda):
    """One stablelm-3b layer at full width (LayerNorm, biased projections,
    seeded nonzero biases and norm biases), packed at int3 and int4: 4
    ragged decode steps through the kernels against the same steps
    through the plain versions over the pages the kernels wrote, within 4
    bf16 ulps of the largest logit; int4 also packed == stream bit for
    bit."""
    import copy
    import dataclasses

    from repro_torch.configs import STABLELM_3B
    from repro_torch.engine import PackedAdapter
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.models.params import init_params
    from repro_torch.models.quantized import packed_decode_step
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

    cfg = dataclasses.replace(STABLELM_3B, n_layers=1, vocab_size=4096)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(2),
                         device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    blocks = params["blocks"][0]
    for sub, names in (("attn", ("bq", "bk", "bv", "bo")),
                       ("mlp", ("b_gate", "b_up", "b_down")),
                       ("norm1", ("bias",)), ("norm2", ("bias",))):
        for name in names:
            t = blocks[sub][name]
            blocks[sub][name] = (0.2 * torch.randn(
                t.shape, generator=gen, device=cuda)).to(t.dtype)
    rng = np.random.default_rng(4)
    for bits in (3, 4):
        tree = pack_tree(cfg, params, QuantSpec(bits=bits, group_size=32),
                         device=cuda)
        assert torch.equal(tree.other["attn/bq"], blocks["attn"]["bq"])
        adapter = PackedAdapter(cfg, tree, kv="packed", kv_bits=bits)
        state = adapter.init_state(4, 32)
        for t in range(4):
            slots = torch.arange(min(t + 1, 4), device=cuda)
            tok = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                len(slots))).to(cuda)
            pos = state["pos"]
            before = (sm.launches, pm.launches)
            got, state = packed_decode_step(cfg, tree, state, tok,
                                            slot_ids=slots, kv="packed")
            kernel = pm if bits == 4 else sm
            assert kernel.launches == before[bits == 4] + 7
            kvc = copy.copy(state["packed_kv"])
            kvc.append = lambda *args, **kwargs: None
            frozen = {"pos": pos, "packed_kv": kvc}
            want, _ = packed_decode_step(cfg, tree, frozen, tok,
                                         slot_ids=slots, kv="packed",
                                         plain=True)
            torch.cuda.synchronize()
            largest = want.float().abs().max().item()
            ulp = 2.0 ** (np.floor(np.log2(largest)) - 7)
            assert torch.isfinite(got).all()
            assert (got.float() - want.float()).abs().max().item() \
                <= 4 * ulp
            if bits == 4:
                streamed, _ = packed_decode_step(
                    cfg, tree, frozen, tok, slot_ids=slots, kv="packed",
                    weights="stream")
                assert torch.equal(got, streamed)


def test_apply_moe_moonshot_widths_matches_oracle(cuda):
    """One moonshot-v1-16b-a3b MoE layer at full width (64 experts top-6
    of 2048 x 1408), bf16, at ample capacity: ``apply_moe`` within 4 bf16
    ulps of the largest |y| of ``apply_moe_reference``; in f32 within
    1e-4."""
    import dataclasses

    from repro_torch.configs import MOONSHOT_V1_16B_A3B
    from repro_torch.models import moe

    base = MOONSHOT_V1_16B_A3B
    for dtype, tol in (("bfloat16", None), ("float32", 1e-4)):
        cfg = dataclasses.replace(base, dtype=dtype, moe=dataclasses.replace(
            base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k))
        p = moe.init_moe(torch.Generator(device=cuda).manual_seed(6), cfg,
                         device=cuda)
        x = torch.randn((2, 128, cfg.d_model), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(7)
                        ).to(getattr(torch, dtype))
        assert moe.moe_capacity(128, cfg) == 128
        got, aux = moe.apply_moe(cfg, p, x)
        want = moe.apply_moe_reference(cfg, p, x)
        torch.cuda.synchronize()
        assert got.dtype == x.dtype and torch.isfinite(aux)
        err = (got.float() - want.float()).abs().max().item()
        if tol is None:
            largest = want.float().abs().max().item()
            assert err <= 4 * 2.0 ** (np.floor(np.log2(largest)) - 7)
        else:
            assert err <= tol


#: (K, N) of qwen2-vl-2b's matrices: wq and wo, wk and wv, gate and up,
#: down
QWEN2_VL_MATS = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]


@pytest.mark.parametrize("k,n", QWEN2_VL_MATS)
def test_stream_and_packed_matmul_qwen2_vl_shapes(cuda, k, n):
    """int3 ``stream_matmul`` and int4 ``packed_matmul`` at qwen2-vl-2b's
    widths and M = 1, 4, 8 and 64 (the served batch) against their plain
    versions; int4
    ``packed_matmul`` bit-equal to ``stream_matmul`` over the same codes
    in an Iris stream.  The weights have the model's init scale, K^-0.5,
    so each output is O(1) as on the main path (unit weights would make a
    K=8960 sum ~100 wide, where f32 summation-order noise alone passes
    the 1e-4 tolerance)."""
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.quant import QuantSpec, bits16, pack_codes_u32, quantize

    rng = np.random.default_rng(k + 3 * n)
    qts = {b: quantize(torch.from_numpy(
        rng.standard_normal((k, n), np.float32) * k ** -0.5),
        QuantSpec(bits=b, group_size=32)) for b in (3, 4)}
    words3, w_tab3, s_tab3 = _pack_stream(
        qts[3].codes.numpy().reshape(-1),
        bits16(qts[3].scales).numpy().reshape(-1), 3, k, n, 32, cuda)
    qt = qts[4]
    pw, sc = pack_codes_u32(qt.codes, 4).to(cuda), qt.scales.to(cuda)
    words4, w_tab4, s_tab4 = _pack_stream(
        qt.codes.numpy().reshape(-1), bits16(qt.scales).numpy().reshape(-1),
        4, k, n, 32, cuda)
    for m in (1, 4, 8, 64):
        x = torch.from_numpy(rng.standard_normal((m, k), np.float32)) \
            .to(cuda)
        before = (sm.launches, pm.launches)
        got3 = sm.stream_matmul(x, words3, w_tab3, s_tab3, bits=3,
                                group_size=32)
        got4 = pm.packed_matmul(x, pw, sc, bits=4, group_size=32)
        torch.cuda.synchronize()
        assert (sm.launches, pm.launches) == (before[0] + 1, before[1] + 1)
        torch.testing.assert_close(
            got3, sm.stream_matmul_plain(x, words3, w_tab3, s_tab3, bits=3,
                                         group_size=32),
            rtol=MM_RTOL, atol=MM_ATOL)
        torch.testing.assert_close(
            got4, pm.packed_matmul_plain(x, pw, sc, bits=4, group_size=32),
            rtol=MM_RTOL, atol=MM_ATOL)
        assert torch.equal(got4, sm.stream_matmul(
            x, words4, w_tab4, s_tab4, bits=4, group_size=32))


def test_stream_attention_qwen2_vl_heads(cuda):
    """qwen2-vl-2b's attention: 12 query heads over 2 KV heads (rep 6) of
    head_dim 128, int3, B=4, smax 256, ragged positions."""
    import dataclasses
    import sys

    from repro_torch.configs import QWEN2_VL_2B
    from repro_torch.kvcache import PackedKVCache
    from repro_torch.kvcache import stream_attention as _  # noqa: F401

    sa = sys.modules["repro_torch.kvcache.stream_attention"]
    cfg = dataclasses.replace(QWEN2_VL_2B, n_layers=1)
    b, bits, smax = 4, 3, 256
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert (h, hkv, hd) == (12, 2, 128)
    kvc = PackedKVCache.create(cfg, bits=bits, page_tokens=8, n_slots=b,
                               max_seq=smax, device=cuda)
    rng = np.random.default_rng(128)
    for t in range(smax):
        k = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        v = torch.from_numpy(rng.standard_normal((b, hkv, hd), np.float32))
        kvc.append(k.to(cuda), v.to(cuda), torch.full((b,), t),
                   torch.arange(b), layer=0)
    pos = torch.tensor([255, 130, 31, 0], device=cuda)
    slots = torch.tensor([1, 3, 0, 2], device=cuda)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd), np.float32)) \
        .to(cuda).to(torch.bfloat16)
    tabs = kvc.device_stream_tables()
    args = (kvc.layer_words(0), slots, q, pos, tabs["k"], tabs["k_scales"],
            tabs["v"], tabs["v_scales"])
    before = sa.launches
    got = sa.stream_attention(*args, bits=bits)
    want = sa.stream_attention_plain(*args, bits=bits)
    torch.cuda.synchronize()
    assert sa.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= ATT_ATOL


def test_qwen2_vl_layer_packed_decode_kernels_match_plain(cuda):
    """One qwen2-vl-2b layer at full width (RMSNorm, biased projections
    with seeded nonzero biases, tied embedding, M-RoPE), packed at int3
    and int4: 4 ragged decode steps through the kernels against the same
    steps through the plain versions over the pages the kernels wrote,
    within 4 bf16 ulps of the largest logit; int4 also packed == stream
    bit for bit."""
    import copy
    import dataclasses

    from repro_torch.configs import QWEN2_VL_2B
    from repro_torch.engine import PackedAdapter
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.kvcache import stream_attention as _  # noqa: F401
    from repro_torch.models.params import init_params
    from repro_torch.models.quantized import packed_decode_step
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree
    import sys

    sa = sys.modules["repro_torch.kvcache.stream_attention"]
    cfg = dataclasses.replace(QWEN2_VL_2B, n_layers=1, vocab_size=4096)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(2),
                         device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    blocks = params["blocks"][0]
    for sub, names in (("attn", ("bq", "bk", "bv", "bo")),
                       ("mlp", ("b_gate", "b_up", "b_down"))):
        for name in names:
            t = blocks[sub][name]
            blocks[sub][name] = (0.2 * torch.randn(
                t.shape, generator=gen, device=cuda)).to(t.dtype)
    rng = np.random.default_rng(5)
    for bits in (3, 4):
        tree = pack_tree(cfg, params, QuantSpec(bits=bits, group_size=32),
                         device=cuda)
        adapter = PackedAdapter(cfg, tree, kv="packed", kv_bits=bits)
        state = adapter.init_state(4, 32)
        for t in range(4):
            slots = torch.arange(min(t + 1, 4), device=cuda)
            tok = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                len(slots))).to(cuda)
            pos = state["pos"]
            before = (sm.launches, pm.launches, sa.launches)
            got, state = packed_decode_step(cfg, tree, state, tok,
                                            slot_ids=slots, kv="packed")
            kernel = pm if bits == 4 else sm
            assert kernel.launches == before[bits == 4] + 7
            assert sa.launches == before[2] + 1
            kvc = copy.copy(state["packed_kv"])
            kvc.append = lambda *args, **kwargs: None
            frozen = {"pos": pos, "packed_kv": kvc}
            want, _ = packed_decode_step(cfg, tree, frozen, tok,
                                         slot_ids=slots, kv="packed",
                                         plain=True)
            torch.cuda.synchronize()
            largest = want.float().abs().max().item()
            ulp = 2.0 ** (np.floor(np.log2(largest)) - 7)
            assert torch.isfinite(got).all()
            assert (got.float() - want.float()).abs().max().item() \
                <= 4 * ulp
            if bits == 4:
                streamed, _ = packed_decode_step(
                    cfg, tree, frozen, tok, slot_ids=slots, kv="packed",
                    weights="stream")
                assert torch.equal(got, streamed)


@pytest.mark.parametrize("dk,dv,dtype", [(64, 64, "float32"),
                                         (64, 64, "bfloat16"),
                                         (128, 128, "float32"),
                                         (128, 64, "bfloat16")])
def test_ssd_scan_gradient_through_the_kernel(cuda, dk, dv, dtype):
    """A backward through the kernel's forward (``ssd_scan``'s autograd
    Function, one launch counted) against autograd straight through
    ``ssd_scan_plain``, with ``state0`` and the final state in the loss:
    every input's gradient nonzero, finite and within ``SCAN_TOL`` of its
    largest entry (the loss is linear in the outputs, so the two
    backwards differ only where the kernel's forward does)."""
    from repro_torch.kernels import linear_scan as ls

    td = getattr(torch, dtype)
    b, t, h = 2, 300, 4
    arrays = _scan_case(b, t, h, dk, dv, td, cuda, seed=dk + dv)
    rng = np.random.default_rng(3)
    w_out = torch.from_numpy(rng.standard_normal((b, t, h, dv),
                                                 np.float32)).to(cuda)
    w_state = torch.from_numpy(rng.standard_normal((b, h, dk, dv),
                                                   np.float32)).to(cuda)
    grads = []
    for fn in (ls.ssd_scan, ls.ssd_scan_plain):
        xs = [a.detach().requires_grad_(True) for a in arrays]
        before = ls.launches
        out, final = fn(*xs[:4], chunk=128, state0=xs[4], return_state=True)
        assert ls.launches == before + (fn is ls.ssd_scan)
        loss = (out.float() * w_out).sum() + (final * w_state).sum()
        grads.append(torch.autograd.grad(loss, xs))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        largest = want.float().abs().max().item()
        assert largest > 0
        err = (got.float() - want.float()).abs().max().item()
        assert err <= SCAN_TOL["rtol"] * largest, (err, largest)


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """One ``build_train_step`` step of reduced smollm-135m in f32 (B=2,
    S=64) on the card and on the CPU from the same parameters and batch:
    loss within 1e-5 and ``grad_norm`` within 1e-4 relative; every
    updated parameter within 2 lr = 2e-2 of the CPU's, and all but 1e-4
    of the entries within 1e-5.  AdamW's first update is ``g / (|g| +
    eps)``: an entry whose gradient is near roundoff moves by another
    amount, up to 2 lr where it takes the other sign (measured on an H100:
    19 of the 361088 entries beyond 1e-5)."""
    import dataclasses

    from repro_torch.configs import SMOLLM_135M
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.pytree import flatten, tree_map
    from repro_torch.runtime.train_loop import device_batch

    cfg = dataclasses.replace(SMOLLM_135M.reduced(), dtype="float32")
    cpu_state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    card_state = tree_map(lambda x: x.to(cuda), cpu_state)
    batch = SyntheticLMPipeline(cfg.vocab_size, 64, 2, seed=0).next_batch()
    step = build_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=1))
    new_cpu, m_cpu = step(cpu_state, device_batch(batch, "cpu"))
    new_card, m_card = step(card_state, device_batch(batch, cuda))
    torch.cuda.synchronize()
    assert abs(m_card["loss"].item() / m_cpu["loss"].item() - 1) <= 1e-5
    assert abs(m_card["grad_norm"].item() / m_cpu["grad_norm"].item()
               - 1) <= 1e-4
    outliers = total = 0
    for got, want in zip(flatten(new_card["params"]),
                         flatten(new_cpu["params"])):
        err = (got.cpu() - want).abs()
        assert err.max().item() <= 2e-2
        outliers += int((err > 1e-5).sum())
        total += err.numel()
    assert outliers <= 1e-4 * total


def _bundle_layer(bits, *, full_width=True, seed=0):
    """smollm-135m's layer bundle at ``bits``, group 32, packed on the
    host with seeded codes and bf16 scale / norm patterns."""
    from repro_torch.api import plan_layer_stack
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.core.iris import LayoutCache
    from repro_torch.plan import pack_bundle
    from repro_torch.quant import QuantSpec

    cfg = SMOLLM_135M if full_width else SMOLLM_135M.reduced()
    stack = plan_layer_stack(cfg, QuantSpec(bits=bits, group_size=32),
                             n_layers=1, cache=LayoutCache())
    rng = np.random.default_rng(seed)
    data = {}
    for b in stack.bundle:
        if b.width_bits == 16:
            vals = rng.uniform(0.01, 0.1, b.n_elems) \
                if b.name.endswith("_scales") else rng.standard_normal(
                    b.n_elems)
            data[b.name] = (vals.astype(np.float32).view(np.uint32)
                            >> np.uint32(16)).astype(np.uint64)
        else:
            data[b.name] = rng.integers(0, 1 << bits, b.n_elems,
                                        dtype=np.uint64)
    pb = pack_bundle(list(stack.bundle), data=data, cache=LayoutCache())
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    mats = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return stack, pb.buffer, mats


@pytest.mark.parametrize("bits", [5, 6, 7])
def test_matmul_direct_int5_to_int7_on_the_card(cuda, bits):
    """``LayerStackPlan.matmul_direct`` of smollm-135m's seven matrices at
    full width: one ``stream_matmul`` launch each, within the stated
    tolerance of the plain version on the same words and tables, and bit
    for bit the ``Plan.matmul_direct`` of the uint8 rows."""
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.kernels.ref import table_tensor

    stack, buf, mats = _bundle_layer(bits, seed=bits)
    words = sm.stream_words(stack.exec_program(), buf)
    assert words.is_cuda
    rng = np.random.default_rng(bits)
    for name, (k, n) in mats.items():
        x = torch.from_numpy(rng.standard_normal((4, k), np.float32)).to(cuda)
        before = sm.launches
        got = stack.matmul_direct(x, words, name, (k, n))
        torch.cuda.synchronize()
        assert got.is_cuda and sm.launches == before + 1, name
        tabs = stack.stream_tables(name, (k, n))
        w_tab = table_tensor(tabs.w_tab, cuda)
        s_tab = table_tensor(tabs.s_tab, cuda)
        want = sm.stream_matmul_plain(x, words, w_tab, s_tab, bits=bits,
                                      group_size=tabs.group_size)
        torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)
        rows = stack.plans[0].matmul_direct(
            x, buf, name, (k, n), scales=f"{name}_scales",
            group_size=tabs.group_size, elem_widths=stack.elem_widths)
        assert torch.equal(got, rows), name


@pytest.mark.parametrize("bits", [3, 5, 7])
def test_stream_words_on_the_card_equal_the_host_words(cuda, bits):
    from repro_torch.kernels.stream_matmul import stream_words

    stack, buf, _ = _bundle_layer(bits, full_width=False, seed=bits)
    prog = stack.exec_program()
    host = prog.buffer_words32(buf).reshape(-1)
    from_numpy = stream_words(prog, buf)
    from_rows = stream_words(prog, torch.from_numpy(buf).to(cuda))
    assert from_numpy.is_cuda and from_rows.is_cuda
    assert np.array_equal(from_numpy.cpu().numpy().view(np.uint32), host)
    assert torch.equal(from_numpy, from_rows)
    on_cpu = stream_words(prog, buf, device="cpu")
    assert torch.equal(on_cpu, from_numpy.cpu())


def test_schedule_many_pool_after_cuda_init_equals_serial(cuda,
                                                          monkeypatch):
    """The pool's workers start cleanly from a process that holds CUDA
    and torch's threads (its fallback warning is an error here), within
    a bounded time, and give the serial run's layouts and counters."""
    import warnings

    from repro_torch.core import iris
    from repro_torch.core.task import ArraySpec, LayoutProblem

    torch.ones(1024, device=cuda).sum().item()      # CUDA initialised
    torch.randn(256, 256) @ torch.randn(256, 256)   # and torch's threads
    rng = np.random.default_rng(0)
    probs = [LayoutProblem(m=64, arrays=tuple(
        ArraySpec(f"a{i}", int(rng.integers(2, 9)),
                  int(rng.integers(50, 400)), int(rng.integers(1, 40)))
        for i in range(5))) for _ in range(6)]
    serial = iris.LayoutCache()
    want = [lay.count_intervals for lay in
            iris.schedule_many(probs * 2, cache=serial, workers=1)]
    monkeypatch.setattr(iris, "POOL_TIMEOUT_S", 120.0)
    pooled = iris.LayoutCache()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = [lay.count_intervals for lay in
               iris.schedule_many(probs * 2, cache=pooled, workers=2)]
    assert got == want
    assert pooled.stats == serial.stats


# ----------------------------------------------------------------------
# the distributed substrate on one card: each in a fresh process, so the
# pytest process never holds a process group
# ----------------------------------------------------------------------
_ONE_CARD_GROUP = r'''
import sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import SMOLLM_135M
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch import sharding as sh
from repro_torch.models.shard_utils import local, use_mesh

dev = torch.device("cuda")
tmp = tempfile.mkdtemp()
dist.init_process_group("nccl", store=dist.FileStore(tmp + "/store", 1),
                        rank=0, world_size=1)
mesh = make_debug_mesh((1, 1), ("data", "model"), device_type="cuda")
if sys.argv[1] == "train":
    from repro_torch.launch.steps import build_train_step, init_train_state
    cfg = SMOLLM_135M.reduced(n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, d_ff=128, vocab_size=64,
                              head_dim=16, dtype="float32")
    state = init_train_state(cfg, torch.Generator(device=dev)
                             .manual_seed(0), dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 64, (4, 16)).astype(np.int32))
    batch = {"tokens": toks.to(dev), "labels": toks.roll(-1, 1).to(dev)}
    step = build_train_step(cfg)
    s, want = state, []
    for _ in range(2):
        s, m = step(s, batch)
        want.append(float(m["loss"]))
    ps = sh.param_shardings(state["params"], mesh, fsdp=True)
    s = sh.place(state, {"params": ps, "opt": sh.opt_state_shardings(
        state["opt"], ps, mesh)})
    b = sh.place(batch, sh.batch_sharding(batch, mesh))
    got = []
    with use_mesh(mesh):
        for _ in range(2):
            s, m = step(s, b)
            got.append(float(local(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=1e-5)
elif sys.argv[1] == "jamba":
    import dataclasses
    from repro_torch.configs import JAMBA_1_5_LARGE
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.launch.steps import build_train_step, init_train_state
    cfg = dataclasses.replace(JAMBA_1_5_LARGE.reduced(moe=None, n_layers=8),
                              dtype="float32")
    state = init_train_state(cfg, torch.Generator(device=dev)
                             .manual_seed(0), dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                            .astype(np.int32))
    batch = {"tokens": toks.to(dev), "labels": toks.roll(-1, 1).to(dev)}
    step = build_train_step(cfg)
    s, want = state, []
    for _ in range(2):
        s, m = step(s, batch)
        want.append(float(m["loss"]))
    ps = sh.param_shardings(state["params"], mesh, fsdp=True)
    s = sh.place(state, {"params": ps, "opt": sh.opt_state_shardings(
        state["opt"], ps, mesh)})
    b = sh.place(batch, sh.batch_sharding(batch, mesh))
    got = []
    ls.launches = 0
    with use_mesh(mesh):
        for _ in range(2):
            s, m = step(s, b)
            got.append(float(local(m["loss"])))
    # 7 Mamba sublayers, forward and remat recompute, 2 steps
    assert ls.launches == 28, ls.launches
    np.testing.assert_allclose(got, want, rtol=1e-5)
else:
    from repro_torch.engine import (Engine, EngineConfig, EngineRequest,
                                    PackedAdapter)
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree
    cfg = SMOLLM_135M.reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    tree = pack_tree(cfg, params, QuantSpec(bits=3, group_size=32),
                     device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 4).tolist()
               for _ in range(6)]

    def serve(t):
        eng = Engine(PackedAdapter(cfg, t, kv="packed", kv_bits=3),
                     EngineConfig(batch_size=4, max_seq=64,
                                  max_backlog=None))
        reqs = [EngineRequest(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        assert eng.run_until_drained(max_steps=500).completed == 6
        return [r.generated for r in reqs]
    want = serve(tree)
    with use_mesh(mesh):
        got = serve(sh.place(tree, sh.packed_tree_shardings(tree, mesh)))
    assert got == want, (got, want)
dist.destroy_process_group()
print("SUBPROCESS_OK")
'''


def _one_card(mode: str) -> None:
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", _ONE_CARD_GROUP, mode], capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0 and "SUBPROCESS_OK" in out.stdout, \
        out.stderr[-3000:]


def test_sharded_train_step_on_one_card_equals_unsharded(cuda):
    """Reduced smollm (f32) placed by the rules on a (1, 1) NCCL mesh:
    two train steps' losses within 1e-5 of the unplaced steps'."""
    _one_card("train")


def test_placed_packed_serve_on_one_card_keeps_tokens(cuda):
    """A reduced int3 smollm tree placed by ``packed_tree_shardings``
    serves through ``Engine(PackedAdapter)`` with the unplaced tree's
    greedy tokens (the kernels on the card)."""
    _one_card("serve")


def test_placed_jamba_train_step_on_one_card_equals_unplaced(cuda):
    """Reduced jamba (``moe=None``, one period: 7 Mamba sublayers and an
    attention one; f32) placed by the rules on a (1, 1) NCCL mesh: two
    train steps' losses within 1e-5 of the unplaced steps', the Mamba
    scans launching the ``ssd_scan`` kernel (28 launches)."""
    _one_card("jamba")


def test_quickstart_on_the_card(cuda, capsys):
    from repro_torch.examples import quickstart
    from repro_torch.kernels import layout_decode as ld

    before = ld.fused_launches
    rep = quickstart.main([])
    out = capsys.readouterr().out
    assert ld.fused_launches == before + 1
    assert "numpy == cuda == original data for all arrays  [OK]" in out
    assert rep.steps_run == 60
    assert sum(rep.losses[-5:]) < sum(rep.losses[:5])


@pytest.mark.parametrize("bits", [8, 4, 3])
def test_packed_serving_on_the_card(cuda, bits):
    """The example's main at each width: one pack launch and one restore
    decode launch a layer; 7 matmul launches a layer a step (lane-packed
    at int8 / int4, stream-direct at int3) over its 8 generation steps
    and the agreement step; the restore bit-identical; the tokens those
    of the plain versions on the card."""
    from repro_torch.examples import packed_serving
    from repro_torch.kernels import layout_decode as ld
    from repro_torch.kernels import layout_pack as lp
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.models.quantized import packed_decode_step

    def counts():
        return (lp.launches, ld.fused_launches, pm.launches, sm.launches)

    before = counts()
    res = packed_serving.main(["--bits", str(bits)])
    got = [a - b for a, b in zip(counts(), before)]
    n = res["cfg"].n_layers
    mm = (0, 7 * n * 9) if bits == 3 else (7 * n * 9, 0)
    assert got == [n, n, *mm]
    assert res["restore_same"]
    cfg, pp = res["cfg"], res["tree"]
    from repro_torch.models.model import Model

    state = Model(cfg).init_decode_state(4, packed_serving.MAX_SEQ,
                                         device=cuda)
    plain = packed_serving.generate(
        lambda st, t: packed_decode_step(cfg, pp, st, t, plain=True),
        state, res["first"], 8)
    assert plain == res["tokens"]


def test_train_lm_small_preset_learns_on_the_card(cuda, tmp_path):
    from repro_torch.examples import train_lm

    rep = train_lm.main(["--ckpt", str(tmp_path / "ckpt")])
    assert rep.steps_run == 300 and np.isfinite(rep.losses).all()
    assert np.mean(rep.losses[-10:]) < 0.8 * np.log(2048)


def test_fp8_kv_decode_on_the_card(cuda):
    """Reduced smollm in bf16, greedy dense decode from one state with a
    bf16 and a float8_e5m2 cache: the fp8 cache is half the bytes and
    its logits stay within the reference's bar of the bf16 logits."""
    import dataclasses

    from repro_torch.configs import SMOLLM_135M
    from repro_torch.models.model import Model

    cfg = SMOLLM_135M.reduced()
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    logits, nbytes = [], []
    for kv in ("", "float8_e5m2"):
        model = Model(dataclasses.replace(cfg, kv_cache_dtype=kv),
                      remat="none")
        st = model.init_decode_state(4, 32, device=cuda)
        nbytes.append(sum(st[k].numel() * st[k].element_size()
                          for k in ("k_cache", "v_cache")))
        t = torch.tensor([3, 5, 7, 11], dtype=torch.int32, device=cuda)
        out = []
        for _ in range(16):
            lg, st = model.decode_step(params, st, t)
            t = lg.argmax(-1).to(torch.int32)
            out.append(lg.float())
        logits.append(torch.stack(out))
    assert st["k_cache"].dtype == torch.float8_e5m2
    assert nbytes[1] * 2 == nbytes[0]
    assert torch.isfinite(logits[1]).all()
    for a, b in zip(*logits):
        assert (a - b).abs().max() < 0.35 * a.abs().max() + 0.5
