"""The port's packed serving slice against the reference, end to end.

Reduced smollm-135m (2 layers, d_model 128).  The reference's
``Model.init`` weights are handed over with ``params_from_jax``; both
packages quantize, plan and pack them (streams and int4 kernel views held
byte-identical), and both run ``packed_decode_step`` — the reference
through its Pallas kernels in interpret mode, the port through its
kernels' plain versions; int3 serves stream-direct (``stream_matmul``) in
both, int4 through the lane-packed views (``packed_matmul``) in both.
Logits are bf16 and computed in another order of f32 sums, so they are
held within ``LOGIT_ATOL`` of the reference; greedy tokens must be equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.iris import LayoutCache as RefCache  # noqa: E402
from repro.kvcache import PackedKVCache as RefKV  # noqa: E402
from repro.models.model import Model  # noqa: E402
from repro.models.quantized import packed_decode_step as ref_step  # noqa: E402
from repro.quant import QuantSpec as RefSpec  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core.iris import LayoutCache as PortCache  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    Engine,
    EngineConfig,
    EngineRequest,
    PackedAdapter,
)
from repro_torch.kvcache import PackedKVCache as PortKV  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.models.quantized import (  # noqa: E402
    init_decode_state,
    packed_decode_step,
)
from repro_torch.quant import QuantSpec  # noqa: E402
from repro_torch.tree import LayoutManifest, pack_tree  # noqa: E402

#: bf16 logits of a 2-layer model, |logit| <= ~2.1: a few bf16 ulps (the
#: difference measured on the CPU is 0, but the f32 sums may reorder)
LOGIT_ATOL = 3e-2
MAX_SEQ = 32


@pytest.fixture(scope="module")
def models():
    rcfg = get_config("smollm-135m").reduced()
    pcfg = port_configs.SMOLLM_135M.reduced()
    params = Model(rcfg, remat="none").init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return rcfg, pcfg, params, np_params


@pytest.fixture(scope="module")
def trees(models):
    rcfg, pcfg, params, np_params = models
    out = {}
    for bits in (3, 4):
        rt = ref_api.pack_tree(rcfg, params, RefSpec(bits=bits,
                                                     group_size=32),
                               cache=RefCache())
        pt = pack_tree(pcfg, params_from_jax(np_params, device="cpu"),
                       QuantSpec(bits=bits, group_size=32),
                       cache=PortCache(), device="cpu")
        out[bits] = (rt, pt)
    return out


def test_params_from_jax_carries_reference_init(models):
    _, _, params, np_params = models
    pt = params_from_jax(np_params, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(ref_leaves) == 11
    for path, leaf in ref_leaves:
        node = pt
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        a = np.asarray(leaf)
        assert tuple(node.shape) == a.shape
        assert str(node.dtype).split(".")[-1] == a.dtype.name
        got = node.view(torch.int16) if node.dtype == torch.bfloat16 \
            else node
        want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [3, 4])
def test_pack_tree_matches_reference(trees, bits):
    rt, pt = trees[bits]
    assert np.array_equal(pt.streams.numpy(), np.asarray(rt.streams))
    assert pt.manifest.to_json_dict() == rt.manifest.to_json_dict()
    back = LayoutManifest.from_json(rt.manifest.to_json())
    assert back == pt.manifest
    for key, s in rt.scales.items():
        assert np.array_equal(pt.scales[key].view(torch.int16).numpy(),
                              np.asarray(s).view(np.int16)), key
    # lane-packed kernel views exactly for the lane-packable widths, bit
    # for bit the reference's (int4 then serves through packed_matmul)
    assert sorted(pt.packed) == sorted(rt.packed)
    assert bool(pt.packed) == (bits == 4)
    for key, v in rt.packed.items():
        assert np.array_equal(pt.packed[key].numpy().view(np.uint32),
                              np.asarray(v)), key


def _ref_state(cfg, kv, bits, b):
    state = Model(cfg, remat="none").init_decode_state(b, MAX_SEQ)
    if kv == "packed":
        state["packed_kv"] = RefKV.create(cfg, bits=bits, page_tokens=8,
                                          n_slots=b, max_seq=MAX_SEQ,
                                          cache=RefCache())
    return state


def _port_state(cfg, kv, bits, b):
    state = init_decode_state(cfg, b, MAX_SEQ, kv=kv, device="cpu")
    if kv == "packed":
        state["packed_kv"] = PortKV.create(cfg, bits=bits, page_tokens=8,
                                           n_slots=b, max_seq=MAX_SEQ,
                                           cache=PortCache(), device="cpu")
    return state


@pytest.mark.parametrize("bits,kv", [(3, "packed"), (4, "packed"),
                                     (3, "dense")])
def test_decode_logits_and_greedy_tokens_match_reference(models, trees,
                                                         bits, kv):
    """Two forced prompt tokens, then 8 greedy steps, batch 2."""
    rcfg, pcfg, _, _ = models
    rt, pt = trees[bits]
    rs, ps = _ref_state(rcfg, kv, bits, 2), _port_state(pcfg, kv, bits, 2)
    prompt = [[17, 301], [250, 3]]
    tok = np.asarray([p[0] for p in prompt], np.int32)
    for step in range(10):
        rl, rs = ref_step(rcfg, rt, rs, jnp.asarray(tok), interpret=True,
                          kv=kv)
        pl, ps = packed_decode_step(pcfg, pt, ps, torch.from_numpy(tok),
                                    kv=kv)
        rl = np.asarray(rl).astype(np.float32)
        pl = pl.float().numpy()
        assert pl.shape == rl.shape == (2, pcfg.vocab_size)
        np.testing.assert_allclose(pl, rl, rtol=0, atol=LOGIT_ATOL)
        greedy_r, greedy_p = rl.argmax(-1), pl.argmax(-1)
        if step == 0:
            tok = np.asarray([p[1] for p in prompt], np.int32)
        else:
            assert np.array_equal(greedy_p, greedy_r), step
            tok = greedy_p.astype(np.int32)
    assert ps["pos"].tolist() == np.asarray(rs["pos"]).tolist() == [10, 10]
    if kv == "packed":
        assert np.array_equal(ps["packed_kv"].host_pages(),
                              np.asarray(rs["packed_kv"].pages))


def test_ragged_rows_bit_identical_to_full_batch(models, trees):
    _, pcfg, _, _ = models
    _, pt = trees[3]
    toks = torch.tensor([5, 9, 77])
    full, fs = packed_decode_step(pcfg, pt, _port_state(pcfg, "packed", 3, 3),
                                  toks, kv="packed")
    state = _port_state(pcfg, "packed", 3, 3)
    ragged, rs = packed_decode_step(pcfg, pt, state, toks[[2, 0]],
                                    slot_ids=torch.tensor([2, 0]),
                                    kv="packed")
    assert torch.equal(ragged, full[[2, 0]])
    assert rs["pos"].tolist() == [1, 0, 1] and fs["pos"].tolist() == [1, 1, 1]
    got = rs["packed_kv"].layer_words(0)[[0, 2]]
    want = fs["packed_kv"].layer_words(0)[[0, 2]]
    assert torch.equal(got, want)


def _single_stream(cfg, tree, req, bits):
    state = _port_state(cfg, "packed", bits, 1)
    out, tok = [], req.prompt[0]
    for p in range(len(req.prompt) + req.max_new_tokens - 1):
        logits, state = packed_decode_step(cfg, tree, state,
                                           torch.tensor([tok]), kv="packed")
        if p + 1 < len(req.prompt):
            tok = req.prompt[p + 1]
        else:
            tok = int(logits[0].float().argmax())
            out.append(tok)
    return out


@pytest.mark.parametrize("bits", [3, 4])
def test_engine_tokens_equal_single_stream_loop(models, trees, bits):
    _, pcfg, _, _ = models
    _, pt = trees[bits]
    rng = np.random.default_rng(bits)
    reqs = [EngineRequest(uid=i, prompt=rng.integers(
        1, pcfg.vocab_size, int(rng.integers(2, 5))).tolist(),
        max_new_tokens=4) for i in range(3)]
    eng = Engine(PackedAdapter(pcfg, pt, kv="packed", kv_bits=bits),
                 EngineConfig(batch_size=2, max_seq=MAX_SEQ))
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats.completed == 3
    for r in reqs:
        assert r.generated == _single_stream(pcfg, pt, r, bits), r.uid


def test_dense_oracle_attention_equals_stream_attention(models, trees):
    """``kv_attention="dense"`` (materialized dequantized K/V) gives the
    same logits as the stream attention path over the same pages."""
    _, pcfg, _, _ = models
    _, pt = trees[4]
    outs = []
    for mode in ("stream", "dense"):
        state = _port_state(pcfg, "packed", 4, 2)
        for tok in ([5, 9], [7, 3], [11, 2]):
            logits, state = packed_decode_step(
                pcfg, pt, state, torch.tensor(tok), kv="packed",
                kv_attention=mode)
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])


def test_bytes_per_token_report_matches_reference(models, trees):
    from repro.models.quantized import bytes_per_token_report as ref_report
    from repro_torch.models.quantized import bytes_per_token_report

    rcfg, pcfg, _, _ = models
    rt, pt = trees[3]              # int3: the reference has no kernel views
    assert bytes_per_token_report(pcfg, pt) == ref_report(rcfg, rt)


def test_bytes_per_token_report_int4_views_match_reference(models, trees):
    from repro.models.quantized import bytes_per_token_report as ref_report
    from repro_torch.models.quantized import bytes_per_token_report

    rcfg, pcfg, _, _ = models
    rt, pt = trees[4]              # int4: both trees have kernel views
    assert bytes_per_token_report(pcfg, pt) == ref_report(rcfg, rt)


def test_manifest_resolves_layout_without_scheduling(trees):
    _, pt = trees[3]
    man = LayoutManifest.from_json(pt.manifest.to_json())
    cache = PortCache()
    lay, prov = man.resolve_layout(cache)
    assert prov == "manifest" and cache.misses == 1
    assert lay.count_intervals == pt.layout().count_intervals
    lay2, prov2 = man.resolve_layout(cache)
    assert prov2 == "cache-hit" and lay2.count_intervals == lay.count_intervals


def test_kv_manifest_round_trip_and_lazy_layout(models):
    from repro_torch.kvcache import KVManifest

    _, pcfg, _, _ = models
    kvc = PortKV.create(pcfg, bits=3, page_tokens=8, n_slots=2,
                        max_seq=16, cache=PortCache(), device="cpu")
    man = KVManifest.from_json_dict(kvc.manifest.to_json_dict())
    assert man == kvc.manifest
    fresh = PortKV(torch.zeros_like(kvc.pages), man)
    assert fresh.program().c_max == kvc.program().c_max
    assert fresh.provenance in ("cache-hit", "manifest")
    for name, tab in kvc.stream_tables().items():
        assert np.array_equal(fresh.stream_tables()[name], tab)


@pytest.mark.parametrize("bits", [3, 4, 8])
def test_dequantize_matches_reference(bits):
    from repro.quant import dequantize as ref_dequantize
    from repro.quant import quantize as ref_quantize
    from repro_torch.quant import dequantize, quantize

    w = np.random.default_rng(bits).standard_normal((128, 48)) \
        .astype(np.float32)
    rq = ref_quantize(jnp.asarray(w), RefSpec(bits=bits, group_size=32))
    pq = quantize(torch.from_numpy(w), QuantSpec(bits=bits, group_size=32))
    np.testing.assert_array_equal(dequantize(pq).numpy(),
                                  np.asarray(ref_dequantize(rq)))


def test_serve_cli_on_cpu_open_loop(tmp_path):
    import json

    from repro_torch.launch import serve

    out = tmp_path / "metrics.json"
    snap = serve.main(["--arch", "smollm-135m", "--reduced", "--packed",
                       "--bits", "3", "--device", "cpu", "--requests", "3",
                       "--batch-size", "2", "--max-new", "3", "--max-seq",
                       "32", "--qps", "200", "--metrics-out", str(out)])
    assert snap["requests"]["completed"] == 3
    assert snap["throughput"]["tokens_generated"] == 9
    assert json.loads(out.read_text())["requests"]["completed"] == 3
