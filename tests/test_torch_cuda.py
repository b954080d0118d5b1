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
