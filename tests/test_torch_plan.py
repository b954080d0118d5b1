"""Planner, host pack and quantization of the port against the reference.

Integer results are held bit-identical: problem signatures, count runs,
C_max, lowered bit offsets, packed stream bytes, quantized codes and
bf16 scale bit patterns.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import exec_plan as ref_exec  # noqa: E402
from repro.core.iris import LayoutCache as RefCache  # noqa: E402
from repro.core.packing import pad_bundle_elements as ref_pad  # noqa: E402
from repro.kvcache import kv_bundle as ref_kv_bundle  # noqa: E402
from repro.kvcache import plan_kv_stack as ref_plan_kv  # noqa: E402
from repro.quant import QuantSpec as RefSpec  # noqa: E402
from repro.quant import quantize as ref_quantize  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import plan as port_plan  # noqa: E402
from repro_torch.core import exec_plan as port_exec  # noqa: E402
from repro_torch.core.iris import LayoutCache as PortCache  # noqa: E402
from repro_torch.core.util import pad_bundle_elements as port_pad  # noqa: E402
from repro_torch.kvcache import kv_bundle as port_kv_bundle  # noqa: E402
from repro_torch.kvcache import plan_kv_stack as port_plan_kv  # noqa: E402
from repro_torch.kvcache.cache import quantize_kv as port_qkv  # noqa: E402
from repro_torch.quant import QuantSpec, quantize  # noqa: E402

BITS = [2, 3, 4, 5, 6, 7, 8]
WIDTHS = ["full", "reduced"]


def _cfgs(width):
    ref = get_config("smollm-135m")
    port = port_configs.SMOLLM_135M
    if width == "reduced":
        return ref.reduced(), port.reduced()
    return ref, port


def _stacks(bits, width):
    rcfg, pcfg = _cfgs(width)
    ref = ref_api.plan_layer_stack(rcfg, RefSpec(bits=bits, group_size=32),
                                   n_layers=1, cache=RefCache())
    port = port_plan.plan_layer_stack(pcfg, QuantSpec(bits=bits,
                                                      group_size=32),
                                      n_layers=1, cache=PortCache())
    return ref, port


def test_configs_match_reference():
    ref, port = get_config("smollm-135m"), port_configs.SMOLLM_135M
    for cfg_pair in ((ref, port), (ref.reduced(), port.reduced())):
        r, p = cfg_pair
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab_size", "head_dim", "act", "norm",
                  "use_bias", "tie_embeddings", "rope_theta", "max_seq_len",
                  "dtype"):
            assert getattr(r, f) == getattr(p, f), f


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("bits", BITS)
def test_layer_stack_plan_matches_reference(bits, width):
    ref, port = _stacks(bits, width)
    assert port.problem.canonical_signature() \
        == ref.problem.canonical_signature()
    rlay, play = ref.plans[0].layout, port.layout
    assert play.count_intervals == rlay.count_intervals
    assert play.c_max == rlay.c_max
    assert port.stream_bytes_per_layer == ref.stream_bytes_per_layer
    assert port.b_eff == pytest.approx(ref.b_eff, abs=0)
    assert port.scheduler_runs == ref.scheduler_runs == 1


@pytest.mark.parametrize("bits", BITS)
def test_lowered_offsets_and_packed_bytes_match_reference(bits):
    """Same layout lowered and packed by both host packs: identical bit
    offsets, u32 word views and stream bytes (reduced width, one layer
    of random codes)."""
    ref, port = _stacks(bits, "reduced")
    rprog, pprog = ref.exec_program(), port.exec_program()
    rng = np.random.default_rng(bits)
    data = {b.name: rng.integers(0, 1 << b.width_bits, b.n_elems,
                                 dtype=np.uint64)
            for b in port.bundle}
    rbuf = ref_exec.pack_compiled(ref.plans[0].layout,
                                  ref_pad(ref.problem, rprog, data),
                                  program=rprog)
    pbuf = port_exec.pack_compiled(port.layout,
                                   port_pad(port.problem, pprog, data),
                                   program=pprog)
    assert np.array_equal(pbuf, rbuf)
    assert np.array_equal(pprog.buffer_words32(pbuf),
                          rprog.buffer_words32(rbuf))
    for i in range(len(pprog.piece_depths)):
        assert np.array_equal(pprog.stream_bit_offsets(i),
                              rprog.stream_bit_offsets(i))
    src_r, sc_r, k_r = ref_exec.pack_kernel_tables(rprog)
    src_p, sc_p, k_p = port_exec.pack_kernel_tables(pprog)
    assert k_p == k_r
    assert np.array_equal(src_p, src_r) and np.array_equal(sc_p, sc_r)


def test_full_width_int3_stream_bytes_match_reference():
    ref, port = _stacks(3, "full")
    rprog, pprog = ref.exec_program(), port.exec_program()
    rng = np.random.default_rng(0)
    data = {b.name: rng.integers(0, 1 << b.width_bits, b.n_elems,
                                 dtype=np.uint64)
            for b in port.bundle}
    rbuf = ref_exec.pack_compiled(ref.plans[0].layout,
                                  ref_pad(ref.problem, rprog, data),
                                  program=rprog)
    pbuf = port_exec.pack_compiled(port.layout,
                                   port_pad(port.problem, pprog, data),
                                   program=pprog)
    assert pbuf.shape == (3039, 512)
    assert np.array_equal(pbuf, rbuf)
    tabs_r = ref_exec.stream_matmul_tables(
        ref.plans[0].layout, "w_down", (1536, 576), scales="w_down_scales",
        group_size=32, program=rprog)
    tabs_p = port_exec.stream_matmul_tables(
        port.layout, "w_down", (1536, 576), scales="w_down_scales",
        group_size=32, program=pprog)
    assert np.array_equal(tabs_p.w_tab, tabs_r.w_tab)
    assert np.array_equal(tabs_p.s_tab, tabs_r.s_tab)
    assert int(tabs_p.w_tab.max()) < (1 << 31)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("bits", BITS)
def test_kv_page_plan_matches_reference(bits, width):
    rcfg, pcfg = _cfgs(width)
    rb = ref_kv_bundle(rcfg, bits, 8)
    pb = port_kv_bundle(pcfg, bits, 8)
    assert [tuple(vars(b).values()) for b in pb] \
        == [tuple(vars(b).values()) for b in rb]
    ref = ref_plan_kv(rcfg, bits=bits, page_tokens=8, n_layers=2,
                      cache=RefCache())
    port = port_plan_kv(pcfg, bits=bits, page_tokens=8, n_layers=2,
                        cache=PortCache())
    assert port.problem.canonical_signature() \
        == ref.problem.canonical_signature()
    assert port.layout.count_intervals == ref.plans[0].layout.count_intervals
    assert (port.scheduler_runs, port.cache_hits) \
        == (ref.scheduler_runs, ref.cache_hits) == (1, 1)


def _bf16_weights(shape, seed):
    """Same bf16 weights for both frameworks, made with numpy."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., :3, 0] = 0.0                      # an all-zero-ish group column
    wj = jnp.asarray(w, jnp.bfloat16)
    wt = torch.from_numpy(np.asarray(wj).view(np.int16).copy()) \
        .view(torch.bfloat16)
    return wj, wt


@pytest.mark.parametrize("bits", BITS)
def test_quantize_bit_identical(bits):
    wj, wt = _bf16_weights((256, 96), bits)
    rq = ref_quantize(wj, RefSpec(bits=bits, group_size=32))
    pq = quantize(wt, QuantSpec(bits=bits, group_size=32))
    assert torch.equal(pq.codes, torch.from_numpy(np.asarray(rq.codes)))
    rs = np.asarray(rq.scales).view(np.uint16).astype(np.int32)
    ps = pq.scales.view(torch.int16).to(torch.int32) & 0xFFFF
    assert torch.equal(ps, torch.from_numpy(rs))


def test_quantize_batched_layers_match_vmap():
    wj, wt = _bf16_weights((3, 128, 40), 11)
    spec = RefSpec(bits=3, group_size=32)
    rq = jax.vmap(lambda w: ref_quantize(w, spec))(wj)
    pq = quantize(wt, QuantSpec(bits=3, group_size=32))
    assert torch.equal(pq.codes, torch.from_numpy(np.asarray(rq.codes)))
    assert torch.equal(pq.scales.view(torch.int16),
                       torch.from_numpy(np.asarray(rq.scales)
                                        .view(np.int16)))


@pytest.mark.parametrize("bits", BITS)
def test_quantize_kv_bit_identical(bits):
    from repro.kvcache import quantize_kv as ref_qkv

    # bf16-valued inputs: they tell a true division from a multiply by
    # the reciprocal, which the reference's eager decode path does not do
    x = np.asarray(jnp.asarray(np.random.default_rng(bits).standard_normal(
        (2000, 3, 64)), jnp.bfloat16).astype(jnp.float32)).copy()
    x[0, 0] = 0.0
    rc, rs = ref_qkv(jnp.asarray(x), bits)
    pc, ps = port_qkv(torch.from_numpy(x), bits)
    assert np.array_equal(pc.numpy(), np.asarray(rc).astype(np.int64))
    assert np.array_equal(ps.numpy(), np.asarray(rs).astype(np.int64))
