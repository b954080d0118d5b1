"""Launch shapes of the port's split kernels, on the CPU.

``attention_launch`` and ``matmul_launch`` are the plain Python functions
that pick the grids of ``csrc/stream_attention.cu`` and
``csrc/stream_matmul.cu``; the kernels themselves run only on a card
(``tests/test_torch_cuda.py``).  Here: the splits cover the sequence,
shared memory stays within an H100 block's 227 KB whatever the context,
the grids cover the card's 132 SMs at smollm-135m's shapes, the launch
functions refuse what the kernels refuse, and on CPU tensors the
wrappers take the plain versions without launching.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import SMOLLM_135M
from repro_torch.kernels import stream_matmul as sm
from repro_torch.kvcache import stream_attention as sa

SMS = 132

#: (K, N) of smollm-135m's seven matrices: wq, wk, wv, wo, gate, up, down
SMOLLM_MATS = [(576, 576), (576, 192), (576, 192), (576, 576),
               (576, 1536), (576, 1536), (1536, 576)]

SMAXES = [1, 7, 31, 32, 33, 100, 256, 296, 2048, 32768]


@pytest.mark.parametrize("smax", SMAXES)
@pytest.mark.parametrize("b,hkv", [(1, 1), (4, 3), (3, 8), (64, 3)])
def test_attention_splits_cover_smax(b, hkv, smax):
    splits, tpb, _ = sa.attention_launch(b, hkv, 3, 64, smax)
    assert 1 <= splits <= sa.MAX_SPLITS
    assert splits * tpb >= smax > (splits - 1) * tpb   # no empty split


@pytest.mark.parametrize("hd", [1, 5, 64, 128, 256])
@pytest.mark.parametrize("rep", [1, 3, 8])
def test_attention_shared_memory_bounded_and_independent_of_smax(rep, hd):
    sizes = {sa.attention_launch(4, 3, rep, hd, smax)[2] for smax in SMAXES}
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


@pytest.mark.parametrize("args", [(4, 3, 9, 64, 256), (4, 3, 0, 64, 256),
                                  (4, 3, 3, 257, 256), (4, 3, 3, 0, 256),
                                  (0, 3, 3, 64, 256), (4, 3, 3, 64, 0)])
def test_attention_launch_refuses_what_the_kernel_refuses(args):
    with pytest.raises(ValueError):
        sa.attention_launch(*args)


@pytest.mark.parametrize("k,n", SMOLLM_MATS)
@pytest.mark.parametrize("m", range(1, 9))
def test_matmul_grid_covers_the_sms_at_smollm_shapes(m, k, n):
    bn, grid = sm.matmul_launch(m, k, n)
    assert bn in (8, 16, 32)
    assert grid[1] == sm.K_RANGES and grid[2] == 1
    assert grid[0] * bn >= n > (grid[0] - 1) * bn
    assert grid[0] * grid[1] * grid[2] >= SMS


def test_matmul_launch_prefers_wide_tiles_and_refuses_bad_shapes():
    assert sm.matmul_launch(4, 576, 1536)[0] == 32
    assert sm.matmul_launch(4, 576, 192)[0] == 8
    assert sm.matmul_launch(4, 32, 1) == (8, (1, 8, 1))
    assert sm.matmul_launch(17, 64, 64)[1] == (8, 8, 3)
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
