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
