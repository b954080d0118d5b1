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
    every smollm matrix at M = 1, 4 and 8."""
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import stream_matmul as sm

    tree = int4_layer
    pw, sc = tree.packed[key][0], tree.scales[key][0]
    k = sc.shape[0] * tree.spec.group_size
    rng = np.random.default_rng(k)
    for m in (1, 4, 8):
        x = torch.from_numpy(rng.standard_normal((m, k), np.float32)) \
            .to(cuda)
        before = sm.launches
        streamed = tree.matmul_direct(x, key, 0)
        packed = pm.packed_matmul(x, pw, sc, bits=tree.spec.bits,
                                  group_size=tree.spec.group_size)
        torch.cuda.synchronize()
        assert sm.launches == before + 1
        assert torch.equal(streamed, packed), (key, m)
