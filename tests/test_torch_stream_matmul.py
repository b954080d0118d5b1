"""``stream_matmul``'s plain version against the reference Pallas kernel.

The JAX side runs ``repro.kernels.stream_matmul`` in interpret mode on
the CPU, as the reference's own tests do; the port's wrapper, given CPU
tensors, runs its plain PyTorch version.  Extraction is held bit-exact;
the float outputs within ``rtol=1e-5, atol=1e-4`` because the f32 sums
are taken in another order.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import build_stream_case  # noqa: E402
from repro.kernels.ref import _extract_ref  # noqa: E402
from repro.kernels.stream_matmul import stream_matmul as ref_mm  # noqa: E402
from repro.kernels.stream_matmul import stream_words  # noqa: E402
from repro_torch.kernels import stream_matmul as port_sm  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    extract,
    table_tensor,
    words_tensor,
)

RTOL, ATOL = 1e-5, 1e-4

#: (M, K, N): ragged M (incl. 1), K a non-power-of-two multiple of the
#: group, N off every tile
SHAPES = [(7, 192, 96), (1, 96, 33), (16, 256, 130)]


def _port_operands(prog, buf, tabs):
    words = words_tensor(prog.buffer_words32(buf).reshape(-1), "cpu")
    return words, table_tensor(tabs.w_tab, "cpu"), \
        table_tensor(tabs.s_tab, "cpu")


@pytest.mark.parametrize("width", [1, 3, 5, 7, 13, 16, 31, 32])
def test_extract_bit_exact(width):
    rng = np.random.default_rng(width)
    words = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    tab = rng.integers(0, 300 * 32 - width, (17, 9)).astype(np.uint32)
    tab[0, 0] = 0                                   # word-aligned
    tab[0, 1] = 299 * 32 + 32 - width               # ends at the last bit
    want = _extract_ref(words, tab, width)
    got = extract(words_tensor(words, "cpu"), table_tensor(tab, "cpu"),
                  width)
    assert got.shape == tab.shape
    assert np.array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8])
def test_plain_matches_pallas_interpret(bits, shape):
    m, k, n = shape
    _, _, _, prog, buf, tabs = build_stream_case(bits, 32, k, n, seed=m)
    x = np.random.default_rng(bits * 7 + m).standard_normal((m, k)) \
        .astype(np.float32)
    want = np.asarray(ref_mm(jnp.asarray(x), stream_words(prog, buf),
                             jnp.asarray(tabs.w_tab), jnp.asarray(tabs.s_tab),
                             bits=bits, group_size=32, interpret=True))
    words, w_tab, s_tab = _port_operands(prog, buf, tabs)
    got = port_sm.stream_matmul(torch.from_numpy(x), words, w_tab, s_tab,
                                bits=bits, group_size=32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    _, _, _, prog, buf, tabs = build_stream_case(3, 32, 64, 40)
    words, w_tab, s_tab = _port_operands(prog, buf, tabs)
    x = torch.ones((2, 64))
    before = port_sm.launches
    a = port_sm.stream_matmul(x, words, w_tab, s_tab, bits=3, group_size=32)
    b = port_sm.stream_matmul_plain(x, words, w_tab, s_tab, bits=3,
                                    group_size=32)
    assert torch.equal(a, b)
    assert port_sm.launches == before


def test_wrapper_validates_operands():
    _, _, _, prog, buf, tabs = build_stream_case(3, 32, 64, 40)
    words, w_tab, s_tab = _port_operands(prog, buf, tabs)
    with pytest.raises(ValueError, match="group_size"):
        port_sm.stream_matmul(torch.ones((2, 64)), words, w_tab, s_tab,
                              bits=3, group_size=48)
    with pytest.raises(ValueError, match="int32"):
        port_sm.stream_matmul(torch.ones((2, 64)), words.to(torch.int64),
                              w_tab, s_tab, bits=3, group_size=32)
    with pytest.raises(ValueError, match="K"):
        port_sm.stream_matmul(torch.ones((2, 32)), words, w_tab, s_tab,
                              bits=3, group_size=32)
