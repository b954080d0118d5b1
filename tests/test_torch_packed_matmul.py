"""The port's ``packed_matmul`` (plain version on the CPU) against the
reference, and the lane-packed serving path.

* Within ``RTOL`` / ``ATOL`` of the reference's Pallas ``packed_matmul``
  in interpret mode, at bits 2, 4 and 8 and shapes that its blocks tile:
  both sum f32 products of the same dequantized weights, in K blocks, in
  another order inside a block.
* Within the same tolerance of the reference's oracle
  ``packed_matmul_ref`` at smollm-135m's full matrix shapes, which the
  reference's serving path cannot tile (its Pallas kernel raises there).
* Bit-equal to the port's ``stream_matmul`` on the same codes: both sum
  in the same order, so on one tree ``weights="packed"`` and
  ``weights="stream"`` give the same logits.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.packed_matmul import packed_matmul as ref_packed_matmul  # noqa: E402
from repro.kernels.ref import packed_matmul_ref as ref_oracle  # noqa: E402
from repro.quant import QuantSpec as RefSpec  # noqa: E402
from repro.quant import pack_codes_u32 as ref_pack_codes  # noqa: E402
from repro.quant import quantize as ref_quantize  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core.iris import LayoutCache as PortCache  # noqa: E402
from repro_torch.kernels import packed_matmul as pm  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.quantized import init_decode_state  # noqa: E402
from repro_torch.models.quantized import packed_decode_step  # noqa: E402
from repro_torch.quant import QuantSpec, pack_codes_u32, quantize  # noqa: E402
from repro_torch.tree import pack_tree  # noqa: E402

#: f32 sums of up to 1536 products of O(1) terms in two orders
RTOL, ATOL = 1e-5, 1e-4

#: smollm-135m's four weight matrix shapes (K, N)
SMOLLM_SHAPES = [(576, 576), (576, 192), (576, 1536), (1536, 576)]


def _case(bits, k, n, g, m, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n), np.float32)
    x = rng.standard_normal((m, k), np.float32)
    rq = ref_quantize(jnp.asarray(w), RefSpec(bits=bits, group_size=g))
    pq = quantize(torch.from_numpy(w), QuantSpec(bits=bits, group_size=g))
    assert np.array_equal(pq.codes.numpy(), np.asarray(rq.codes))
    rpw = ref_pack_codes(rq.codes, bits)
    ppw = pack_codes_u32(pq.codes, bits)
    assert np.array_equal(ppw.numpy().view(np.uint32), np.asarray(rpw))
    return x, (rpw, rq.scales), (ppw, pq.scales)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n,g,bk,bn", [(8, 256, 128, 32, 256, 128),
                                           (8, 1024, 256, 128, 512, 128),
                                           (3, 128, 64, 32, 128, 64)])
def test_plain_matches_reference_kernel(bits, m, k, n, g, bk, bn):
    x, (rpw, rsc), (ppw, psc) = _case(bits, k, n, g, m, seed=bits + k)
    want = ref_packed_matmul(jnp.asarray(x), rpw, rsc, bits=bits,
                             group_size=g, block_m=8, block_n=bn,
                             block_k=bk, interpret=True)
    got = pm.packed_matmul(torch.from_numpy(x), ppw, psc, bits=bits,
                           group_size=g)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k,n", SMOLLM_SHAPES)
def test_full_smollm_shapes_against_reference_oracle(k, n):
    """The reference's serving blocks (``block_n=min(128, n)``,
    ``block_k=min(512, k)``) do not tile these shapes, so its Pallas
    kernel raises; its oracle defines the function, and the port
    computes it."""
    x, (rpw, rsc), (ppw, psc) = _case(4, k, n, 32, 8, seed=k * n)
    with pytest.raises(ValueError, match="tile"):
        ref_packed_matmul(jnp.asarray(x), rpw, rsc, bits=4, group_size=32,
                          block_m=8, block_n=min(128, n),
                          block_k=min(512, k), interpret=True)
    want = ref_oracle(jnp.asarray(x), rpw, rsc, bits=4, group_size=32)
    got = pm.packed_matmul(torch.from_numpy(x), ppw, psc, bits=4,
                           group_size=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_validation_and_never_falls_back():
    x = torch.zeros((2, 64))
    w = torch.zeros((8, 16), dtype=torch.int32)
    s = torch.zeros((2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bits"):
        pm.packed_matmul(x, w, s, bits=3, group_size=32)
    with pytest.raises(ValueError, match="K mismatch"):
        pm.packed_matmul(x, w[:4], s, bits=4, group_size=32)
    with pytest.raises(ValueError, match="scales shape"):
        pm.packed_matmul(x, w, s[:1], bits=4, group_size=32)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        pm.packed_matmul(x.to(meta), w.to(meta), s.to(meta), bits=4,
                         group_size=32)


@pytest.fixture(scope="module")
def int4_tree():
    cfg = port_configs.SMOLLM_135M.reduced()
    params = init_params(cfg, torch.Generator().manual_seed(4),
                         device="cpu")
    return cfg, pack_tree(cfg, params, QuantSpec(bits=4, group_size=32),
                          cache=PortCache(), device="cpu")


def test_packed_equals_stream_on_one_tree(int4_tree):
    """Each matrix, and whole decode steps: the lane-packed and the
    stream-direct path give the same bits on the CPU."""
    cfg, pt = int4_tree
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, cfg.d_model), np.float32))
    for key in ("attn/wq", "attn/wk", "mlp/w_up"):
        a = pm.packed_matmul(x, pt.packed[key][1], pt.scales[key][1],
                             bits=4, group_size=32)
        b = pt.matmul_direct(x, key, 1)
        assert torch.equal(a, b), key
    logits = {}
    for weights in ("packed", "stream", "auto"):
        state = init_decode_state(cfg, 2, 16, device="cpu")
        for tok in ([5, 9], [7, 3], [11, 2]):
            out, state = packed_decode_step(cfg, pt, state, torch.tensor(tok),
                                            weights=weights)
        logits[weights] = out
    assert torch.equal(logits["packed"], logits["stream"])
    assert torch.equal(logits["auto"], logits["packed"])


def test_auto_routes_by_tree_and_packed_needs_views(int4_tree):
    cfg, pt = int4_tree
    pm.launches = 0
    state = init_decode_state(cfg, 1, 8, device="cpu")
    packed_decode_step(cfg, pt, state, torch.tensor([3]))
    assert pm.launches == 0          # CPU tensors: the plain version runs
    no_views = pack_tree(cfg, init_params(cfg, torch.Generator()
                                          .manual_seed(4), device="cpu"),
                         QuantSpec(bits=4, group_size=32),
                         with_kernel_views=False, cache=PortCache(),
                         device="cpu")
    assert no_views.packed == {}
    with pytest.raises(ValueError, match="no lane-packed kernel views"):
        packed_decode_step(cfg, no_views, state, torch.tensor([3]),
                           weights="packed")
    with pytest.raises(ValueError, match="lane-packed kernel views need"):
        pack_tree(cfg, {}, QuantSpec(bits=3), with_kernel_views=True,
                  device="cpu")
