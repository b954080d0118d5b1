"""The port's stream uploader (``repro_torch.engine.streams``) against
the reference's (``repro.engine.streams``).

Reduced smollm-135m trees packed by both packages from one weight set
(``_torch_trees``).  On the CPU an upload is a plain copy of the tree's
host words; the uploader's words must equal the tree's resident words
and the reference's host words, its ring and counters must behave as the
reference's, and an ``Engine`` serving through it must give the tokens
of an ``Engine`` that reads the resident streams, and of the reference's
``Engine`` with its own uploader.  The card path (a side CUDA stream,
pinned host words) is tested in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from _torch_trees import configs_and_params, trees  # noqa: E402

from repro.engine import Engine as RefEngine  # noqa: E402
from repro.engine import EngineConfig as RefConfig  # noqa: E402
from repro.engine import EngineRequest as RefRequest  # noqa: E402
from repro.engine import PackedAdapter as RefAdapter  # noqa: E402
from repro.engine import BufferRing as RefRing  # noqa: E402
from repro.engine import StreamUploader as RefUploader  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    BufferRing,
    Engine,
    EngineConfig,
    EngineRequest,
    PackedAdapter,
    StreamUploader,
)
from repro_torch.models.quantized import packed_decode_step  # noqa: E402
from repro_torch.tree import PackedTree  # noqa: E402


@pytest.fixture(scope="module")
def models():
    return configs_and_params()


@pytest.fixture(scope="module")
def packed(models):
    return {bits: trees(models, bits) for bits in (3, 4)}


# ----------------------------------------------------------------------
# the ring
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ring_cls", [BufferRing, RefRing],
                         ids=["port", "ref"])
def test_ring_fifo_eviction_at_depth(ring_cls):
    r = ring_cls(depth=2)
    r.put("a", 1)
    r.put("b", 2)
    r.put("c", 3)
    assert r.keys() == ["b", "c"] and r.evictions == 1
    assert r.get("a") is None and r.get("c") == 3
    assert len(r) == 2 and "b" in r and "a" not in r


@pytest.mark.parametrize("ring_cls", [BufferRing, RefRing],
                         ids=["port", "ref"])
def test_ring_reput_moves_to_end_without_eviction(ring_cls):
    r = ring_cls(depth=2)
    r.put("a", 1)
    r.put("b", 2)
    r.put("a", 10)
    assert r.keys() == ["b", "a"] and r.evictions == 0
    assert r.get("a") == 10


def test_ring_refuses_depth_below_one():
    with pytest.raises(ValueError, match="depth"):
        BufferRing(0)


# ----------------------------------------------------------------------
# the uploader
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bits", [3, 4])
def test_host_stream_words_equal_reference(packed, bits):
    rt, pt = packed[bits]
    for layer in range(pt.n_layers):
        got = pt.host_stream_words(layer)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert not got.is_pinned()           # a CPU tree pins nothing
        assert np.array_equal(got.numpy().view(np.uint32),
                              rt.host_stream_words(layer))
        assert torch.equal(got, pt.layer_stream_words(layer))
    assert pt.host_stream_words(0).data_ptr() == \
        pt.host_stream_words(0).data_ptr()   # copied once, then kept


def test_uploader_words_equal_the_trees_and_counters_match_reference(packed):
    rt, pt = packed[3]
    with StreamUploader(pt) as up, RefUploader(rt) as ref:
        assert up.device == torch.device("cpu") and up.stream is None
        for _lap in range(2):
            for layer in range(pt.n_layers):
                got = up(layer)
                assert torch.equal(got, pt.layer_stream_words(layer))
                # the uploaded copy, never the tree's resident buffer
                assert got.data_ptr() != \
                    pt.layer_stream_words(layer).data_ptr()
                assert got.data_ptr() != \
                    pt.host_stream_words(layer).data_ptr()
                want = np.asarray(ref(layer))
                assert np.array_equal(got.numpy().view(np.uint32), want)
        assert up.stats() == ref.stats()
    s = up.stats()
    assert sorted(s) == ["bytes_uploaded", "prefetch_hits", "ring_depth",
                         "ring_evictions", "sync_fetches", "uploads"]
    assert s["sync_fetches"] == 1 and s["ring_depth"] == 2
    assert s["prefetch_hits"] == 2 * pt.n_layers - 1
    assert s["bytes_uploaded"] == s["uploads"] * pt.manifest.c_max \
        * pt.exec_program().words32 * 4


def test_uploader_keys_lead_with_the_signature(packed):
    _rt, pt = packed[3]
    up = StreamUploader(pt, depth=3)
    up(0)
    assert up.ring.keys() == [(pt.manifest.signature, 0),
                              (pt.manifest.signature, 1)]
    up(pt.n_layers + 1)                  # layer indices wrap: layer 1
    assert up.sync_fetches == 1 and up.prefetch_hits == 1
    assert up.uploads == 2               # layer 0 is still in the ring


def test_uploader_refuses_a_tree_without_streams(packed):
    _rt, pt = packed[3]
    bare = PackedTree(pt.packed, pt.scales, pt.other, None, pt.manifest)
    with pytest.raises(ValueError, match="with_streams=False"):
        StreamUploader(bare)


def test_stream_source_only_on_the_stream_path(packed, models):
    pcfg = models[1]
    _rt, pt4 = packed[4]
    state = PackedAdapter(pcfg, pt4).init_state(2, 16)
    with pytest.raises(ValueError, match="stream-direct path"):
        packed_decode_step(pcfg, pt4, state, torch.tensor([1, 2]),
                           stream_source=StreamUploader(pt4))
    # weights="stream" reads the int4 tree's streams through the uploader
    up = StreamUploader(pt4)
    got, _ = packed_decode_step(pcfg, pt4, state, torch.tensor([1, 2]),
                                weights="stream", stream_source=up)
    want, _ = packed_decode_step(pcfg, pt4, state, torch.tensor([1, 2]),
                                 weights="stream")
    assert torch.equal(got, want) and up.uploads == pcfg.n_layers


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
PROMPTS = [[5, 9], [17, 3, 8], [40], [2, 7, 1, 3]]


def _serve(pcfg, tree, uploader, *, kv: str):
    reqs = [EngineRequest(uid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(PROMPTS)]
    eng = Engine(PackedAdapter(pcfg, tree, uploader=uploader, kv=kv),
                 EngineConfig(batch_size=2, max_seq=32))
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats.completed == len(PROMPTS)
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("kv", ["dense", "packed"])
def test_engine_with_uploader_equals_engine_without(packed, models, kv):
    rcfg, pcfg = models[0], models[1]
    rt, pt = packed[3]
    base, plain_eng = _serve(pcfg, pt, None, kv=kv)
    with StreamUploader(pt) as up:
        uploaded, eng = _serve(pcfg, pt, up, kv=kv)
    assert uploaded == base
    # the reference's engine through its own uploader gives the same tokens
    reqs = [RefRequest(uid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(PROMPTS)]
    with RefUploader(rt) as ref_up:
        ref_eng = RefEngine(RefAdapter(rcfg, rt, uploader=ref_up, kv=kv),
                            RefConfig(batch_size=2, max_seq=32))
        for r in reqs:
            ref_eng.submit(r)
        ref_eng.run_until_drained()
    assert [r.generated for r in reqs] == uploaded
    # stream-bytes accounting and the uploader dict reach the metrics
    assert eng.metrics.stream_bytes == up.bytes_uploaded > 0
    thr = eng.metrics.snapshot()["throughput"]
    assert thr["stream_bytes"] == up.bytes_uploaded
    assert thr["uploader"] == up.stats()
    assert thr["uploader"]["sync_fetches"] == 1
    assert thr["uploader"] == ref_eng.metrics.snapshot()["throughput"][
        "uploader"]
    assert eng.adapter.uploader_stats() == up.stats()
    # without an uploader: no bytes, an empty dict
    plain = plain_eng.metrics.snapshot()["throughput"]
    assert plain["uploader"] == {} and plain["stream_bytes"] == 0
    assert plain_eng.adapter.stream_bytes_uploaded() is None
    assert plain_eng.adapter.uploader_stats() is None
