"""Launch shapes of the port's split kernels, on the CPU.

``attention_launch``, ``matmul_launch`` and ``scan_launch`` are the plain
Python functions that pick the grids of ``csrc/stream_attention.cu``,
``csrc/stream_matmul.cu`` and ``csrc/packed_matmul.cu`` (which share
``matmul_launch``) and ``csrc/ssd_scan.cu``; the kernels themselves run
only on a card (``tests/test_torch_cuda.py``).  Here: the splits cover
the sequence, shared memory stays within an H100 block's 227 KB whatever
the context and the number of query heads per KV head, the grids cover
the card's 132 SMs at smollm-135m's shapes, the launch functions refuse
what the kernels refuse, and on CPU tensors the wrappers take the plain
versions without launching.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import SMOLLM_135M
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import packed_matmul as pm
from repro_torch.kernels import stream_matmul as sm
from repro_torch.kvcache import stream_attention as sa

SMS = 132

#: (K, N) of smollm-135m's seven matrices: wq, wk, wv, wo, gate, up, down
SMOLLM_MATS = [(576, 576), (576, 192), (576, 192), (576, 576),
               (576, 1536), (576, 1536), (1536, 576)]

SMAXES = [1, 7, 31, 32, 33, 100, 256, 296, 2048, 32768]


@pytest.mark.parametrize("smax", SMAXES)
@pytest.mark.parametrize("b,hkv,rep,hd", [
    (1, 1, 3, 64), (4, 3, 3, 64), (3, 8, 3, 64), (64, 3, 3, 64),
    # rep 9 and rep 12 (mistral-large-123b's 96 heads over 8 KV heads)
    (4, 8, 9, 128), (4, 8, 12, 128)])
def test_attention_splits_cover_smax(b, hkv, rep, hd, smax):
    splits, tpb, _ = sa.attention_launch(b, hkv, rep, hd, smax)
    assert 1 <= splits <= sa.MAX_SPLITS
    assert splits * tpb >= smax > (splits - 1) * tpb   # no empty split


@pytest.mark.parametrize("hd", [1, 5, 64, 128, 256])
@pytest.mark.parametrize("rep", [1, 3, 8, 9, 12])
def test_attention_shared_memory_bounded_and_independent_of_smax(rep, hd):
    sizes = {sa.attention_launch(4, 8, rep, hd, smax)[2] for smax in SMAXES}
    assert len(sizes) == 1
    assert sizes.pop() <= sa.MAX_SMEM


def test_attention_grid_splits_the_sequence_at_smollm_shapes():
    cfg = SMOLLM_135M
    hkv, rep, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.head_dim
    for smax in (256, 2048):
        splits, tpb, _ = sa.attention_launch(4, hkv, rep, hd, smax)
        assert (splits, tpb) == (8, smax // 8)       # 96 blocks, not 12
    for b in (11, 16, 64):                          # enough slots: >= SMs
        splits, _, _ = sa.attention_launch(b, hkv, rep, hd, 2048)
        assert b * hkv * splits >= SMS


@pytest.mark.parametrize("args", [(4, 8, 12, 257, 256), (4, 3, 0, 64, 256),
                                  (4, 3, 3, 257, 256), (4, 3, 3, 0, 256),
                                  (0, 3, 3, 64, 256), (4, 3, 3, 64, 0),
                                  (4, 8, 77, 256, 256), (4, 8, -1, 64, 256)])
def test_attention_launch_refuses_what_the_kernel_refuses(args):
    with pytest.raises(ValueError):
        sa.attention_launch(*args)


def test_attention_launch_takes_any_rep_that_fits_a_block():
    """The block loops over the query heads of a KV head in groups of 8
    warps, so rep is bounded only by shared memory: 76 at hd 256."""
    assert sa.attention_launch(4, 8, 76, 256, 2048)[2] <= sa.MAX_SMEM
    assert sa.attention_launch(4, 8, 12, 128, 2048)[:2] == (5, 410)


@pytest.mark.parametrize("k,n", SMOLLM_MATS)
@pytest.mark.parametrize("m", range(1, 9))
def test_matmul_grid_covers_the_sms_at_smollm_shapes(m, k, n):
    bn, grid = sm.matmul_launch(m, k, n)
    assert bn in (8, 16, 32)
    assert grid[1] == sm.K_RANGES and grid[2] == 1
    assert grid[0] * bn >= n > (grid[0] - 1) * bn
    assert grid[0] * grid[1] * grid[2] >= SMS


#: (K, N) of smollm-135m's seven matrices as int4 lane-packed views:
#: (K / 8 words, N)
@pytest.mark.parametrize("k,n", SMOLLM_MATS)
@pytest.mark.parametrize("m", range(1, 9))
def test_packed_matmul_grid_covers_the_sms_at_smollm_shapes(m, k, n):
    """``packed_matmul`` takes its grid from ``matmul_launch``: 144-384
    blocks of the cluster split over K at smollm's int4 shapes."""
    assert pm.matmul_launch is sm.matmul_launch
    bn, grid = pm.matmul_launch(m, k, n)
    assert k % (32 // 4) == 0                # whole words of int4 codes
    assert grid[1] == sm.K_RANGES and grid[2] == 1
    assert grid[0] * bn >= n > (grid[0] - 1) * bn
    assert SMS <= grid[0] * grid[1] * grid[2] <= 384


#: (K, N) of stablelm-3b's and qwen2-vl-2b's seven matrices: wq, wk, wv,
#: wo, gate, up, down
STABLELM_MATS = [(2560, 2560)] * 4 + [(2560, 6912)] * 2 + [(6912, 2560)]
QWEN2_VL_MATS = [(1536, 1536), (1536, 256), (1536, 256), (1536, 1536),
                 (1536, 8960), (1536, 8960), (8960, 1536)]


@pytest.mark.parametrize("k,n", sorted(set(STABLELM_MATS + QWEN2_VL_MATS)))
@pytest.mark.parametrize("m", [9, 16, 64, 65, 128])
def test_matmul_grid_gathers_each_weight_once_per_64_rows(m, k, n):
    """Above M = 8 a block covers 64 rows, so the z extent (the row
    blocks, each a gather of the weight tile) is ceil(M / 64), and the
    grid still covers the SMs at the served models' widths."""
    bn, grid = sm.matmul_launch(m, k, n)
    assert bn in (8, 16, 32)
    assert grid[1] == sm.K_RANGES and grid[2] == -(-m // 64)
    assert grid[0] * bn >= n > (grid[0] - 1) * bn
    assert grid[0] * grid[1] * grid[2] >= SMS
    assert sm.rows_per_block(m) * grid[2] >= m


def test_matmul_launch_prefers_wide_tiles_and_refuses_bad_shapes():
    assert sm.matmul_launch(4, 576, 1536)[0] == 32
    assert sm.matmul_launch(4, 576, 192)[0] == 8
    assert sm.matmul_launch(4, 32, 1) == (8, (1, 8, 1))
    # above M = 8 a block covers 64 rows: one row block up to M = 64
    assert sm.matmul_launch(17, 64, 64)[1] == (8, 8, 1)
    for m, k, n in ((0, 64, 64), (sm.MAX_M + 1, 64, 64), (4, 0, 64),
                    (4, 64, 0)):
        with pytest.raises(ValueError):
            sm.matmul_launch(m, k, n)


def test_attention_wrapper_takes_plain_version_on_cpu_without_launching():
    from repro_torch.kvcache import PackedKVCache

    cfg = SMOLLM_135M.reduced(n_layers=1, n_heads=4, n_kv_heads=2,
                              head_dim=8, d_model=32)
    kvc = PackedKVCache.create(cfg, bits=3, page_tokens=4, n_slots=2,
                               max_seq=8, device="cpu")
    rng = np.random.default_rng(0)
    for t in range(6):
        k = torch.from_numpy(rng.standard_normal((2, 2, 8), np.float32))
        kvc.append(k, 2 * k, torch.full((2,), t), torch.arange(2), layer=0)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8), np.float32)) \
        .to(torch.bfloat16)
    tabs = kvc.device_stream_tables()
    args = (kvc.layer_words(0), torch.tensor([1, 0]), q, torch.tensor([5, 2]),
            tabs["k"], tabs["k_scales"], tabs["v"], tabs["v_scales"])
    before = sa.launches
    got = sa.stream_attention(*args, bits=3)
    assert torch.equal(got, sa.stream_attention_plain(*args, bits=3))
    assert sa.launches == before


@pytest.mark.parametrize("dk,dv", [(1, 1), (13, 30), (64, 64), (128, 64),
                                   (128, 128), (256, 64), (256, 256)])
@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_scan_launch_fits_a_block(dk, dv, elem_bytes):
    """Every head width up to 256 gets a tile and a dv slice whose block
    fits an H100's 227 KB, with at most one 16 x 64 strip of the state per
    warp (8 warps)."""
    tile, dvs, smem = ls.scan_launch(2, 256, dk, dv, elem_bytes)
    assert tile in (16, 32, 64) and dvs in (16, 32, 64)
    assert dvs <= -(-dv // 16) * 16
    assert dvs // 16 * -(-dk // 64) <= 8
    assert smem == ls.scan_smem(tile, dvs, dk, elem_bytes) <= ls.MAX_SMEM


def test_scan_launch_refuses_what_the_kernel_refuses():
    assert ls.scan_launch(2, 256, 64, 64, 2)[:2] == (32, 64)   # jamba
    assert ls.scan_launch(2, 256, 128, 64, 2)[:2] == (64, 64)  # Mamba-2
    for args in ((2, 256, 0, 64), (2, 256, 257, 64), (2, 256, 64, 257),
                 (0, 256, 64, 64), (2, 0, 64, 64)):
        with pytest.raises(ValueError):
            ls.scan_launch(*args, 2)
