"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``).

The on-disk format is the reference's, byte for byte: the same tree
saved by both packages gives byte-equal ``arr_*.npy`` files and equal
``manifest.json`` files apart from ``treedef`` (the reference writes a
serialized jax treedef that nothing reads; the port writes ``null``),
for dense trees with bf16 leaves and ``/`` keys and for packed trees
with and without KV pages.  Each package restores the other's
checkpoint bit for bit.  Everything runs on the CPU (``device="cpu"``).
"""
import json
import pathlib
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import ml_dtypes  # noqa: E402
import torch  # noqa: E402
from _torch_trees import (  # noqa: E402
    MAX_SEQ,
    N_SLOTS,
    configs_and_params,
    filled_kv,
    ref_kv_like,
    trees,
)

from repro.checkpoint.checkpoint import CheckpointManager as RefMgr  # noqa: E402
from repro.core.iris import LayoutCache as RefCache  # noqa: E402
from repro_torch.analysis import AnalysisError  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import (  # noqa: E402
    _flatten,
    _skeletonize,
    _tree_paths,
)
from repro_torch.core.iris import LayoutCache  # noqa: E402
from repro_torch.engine import PackedAdapter  # noqa: E402
from repro_torch.models.quantized import packed_decode_step  # noqa: E402
from repro_torch.tree import PackedTree  # noqa: E402

STEP = "step_00000000"


@pytest.fixture(scope="module")
def models():
    return configs_and_params()


@pytest.fixture(scope="module")
def packed(models):
    return {bits: trees(models, bits) for bits in (3, 4)}


def _files(root: pathlib.Path, step: str = STEP) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted((root / step).iterdir())
            if p.suffix == ".npy"}


def _manifest(root: pathlib.Path, step: str = STEP) -> dict:
    return json.loads((root / step / "manifest.json").read_text())


def _assert_same_on_disk(port_root, ref_root, step: str = STEP) -> None:
    port, ref = _files(port_root, step), _files(ref_root, step)
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name] == ref[name], name
    pm, rm = _manifest(port_root, step), _manifest(ref_root, step)
    assert pm.pop("treedef") is None
    rm.pop("treedef")
    assert pm == rm


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as numpy (bf16 as int16), from either package."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.cpu().numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1] if isinstance(x, torch.Tensor) \
        else np.asarray(x).dtype.name


def _same_tree(port, ref) -> None:
    """Same structure, and leaf for leaf the same dtype name and bits."""
    assert _skeletonize(port)[0] == _skeletonize(ref)[0]
    for path, x, y in zip(_tree_paths(ref), _flatten(port), _flatten(ref)):
        assert _dtype(x) == _dtype(y), path
        assert np.array_equal(_bits(x), _bits(y)), path


# ----------------------------------------------------------------------
# dense checkpoints
# ----------------------------------------------------------------------
def _dense_trees(seed: int = 0):
    """One tree with bf16 leaves, ``/`` keys, a None and a tuple, as the
    port's tensors and as the reference's numpy arrays."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((6, 4)).astype(np.float32)
    bq = rng.standard_normal(5).astype(np.float32)
    codes = rng.integers(0, 255, (3, 7)).astype(np.uint8)
    ids = rng.integers(-9, 9, 4).astype(np.int32)
    port = {"w": {"embed": torch.from_numpy(emb).to(torch.bfloat16),
                  "attn/bq": torch.from_numpy(bq)},
            "codes": torch.from_numpy(codes),
            "list": [torch.from_numpy(ids), None,
                     (torch.from_numpy(emb[0]).to(torch.bfloat16),)]}
    ref = {"w": {"embed": emb.astype(ml_dtypes.bfloat16), "attn/bq": bq},
           "codes": codes,
           "list": [ids, None, (emb[0].astype(ml_dtypes.bfloat16),)]}
    return port, ref


def test_dense_round_trip_bf16_and_slash_keys(tmp_path):
    port, _ = _dense_trees()
    mgr = CheckpointManager(tmp_path)
    path = mgr.save(3, port, {"note": "x"})
    assert pathlib.Path(path).name == "step_00000003"
    meta = _manifest(tmp_path, "step_00000003")
    assert meta["paths"] == ["codes", "list/0", "list/2/0", "w/attn/bq",
                             "w/embed"]
    assert [leaf["dtype"] for leaf in meta["leaves"]] == \
        ["uint8", "int32", "bfloat16", "float32", "bfloat16"]
    back, extra = mgr.restore(port, device="cpu")
    assert extra == {"note": "x"}
    assert back["list"][1] is None and isinstance(back["list"][2], tuple)
    for a, b in ((back["codes"], port["codes"]),
                 (back["list"][0], port["list"][0]),
                 (back["list"][2][0], port["list"][2][0]),
                 (back["w"]["attn/bq"], port["w"]["attn/bq"]),
                 (back["w"]["embed"], port["w"]["embed"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_dense_files_equal_reference_and_restore_across(tmp_path):
    port, ref = _dense_trees(1)
    CheckpointManager(tmp_path / "port").save(0, port, {"k": [1, 2]})
    RefMgr(tmp_path / "ref").save(0, ref, {"k": [1, 2]})
    _assert_same_on_disk(tmp_path / "port", tmp_path / "ref")
    # the reference reads the port's files and the other way round
    ref_back, _ = RefMgr(tmp_path / "port").restore(ref)
    port_back, _ = CheckpointManager(tmp_path / "ref").restore(port,
                                                               device="cpu")
    _same_tree(ref_back, ref)
    _same_tree(port_back, ref)


def test_restore_refuses_other_structures(tmp_path):
    port, _ = _dense_trees()
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(port, device="cpu")
    mgr.save(0, port)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"codes": port["codes"]}, device="cpu")
    other = dict(port, codes=torch.zeros(2, 2, dtype=torch.uint8))
    with pytest.raises(ValueError, match="codes"):
        mgr.restore(other, device="cpu")
    with pytest.raises(ValueError, match="not a packed checkpoint"):
        mgr.restore_packed(device="cpu")


def test_save_async_snapshots_now_and_wait_surfaces_failures(tmp_path):
    port, _ = _dense_trees()
    mgr = CheckpointManager(tmp_path / "ok")
    mgr.save_async(1, port)
    want = port["codes"].clone()
    port["codes"] += 1                     # after the snapshot: not saved
    mgr.wait()
    back, _ = mgr.restore(port, device="cpu")
    assert torch.equal(back["codes"], want)
    # a write that fails on the thread comes back from wait()
    root = tmp_path / "bad"
    bad = CheckpointManager(root)
    shutil.rmtree(root)
    root.write_text("not a directory")
    bad.save_async(7, port)
    with pytest.raises(RuntimeError, match="step 7"):
        bad.wait()
    bad.wait()                             # the failure is reported once


def test_keep_n_garbage_collects(tmp_path):
    port, _ = _dense_trees()
    mgr = CheckpointManager(tmp_path, keep_n=2)
    stale = tmp_path / "step_00000001.tmp-1-2"
    stale.mkdir()
    for step in (1, 2, 3, 4):
        mgr.save(step, port)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert not stale.exists()
    keep_all = CheckpointManager(tmp_path, keep_n=0)
    keep_all.save(5, port)
    assert keep_all.all_steps() == [3, 4, 5]


# ----------------------------------------------------------------------
# packed checkpoints
# ----------------------------------------------------------------------
def _save_both(tmp_path, packed, models, bits: int, with_kv: bool):
    rt, pt = packed[bits]
    kvc = filled_kv(models[1], bits) if with_kv else None
    CheckpointManager(tmp_path / "port").save_packed(
        0, pt, {"tag": bits}, kv=kvc)
    RefMgr(tmp_path / "ref").save_packed(
        0, rt, {"tag": bits}, kv=None if kvc is None else ref_kv_like(kvc))
    return rt, pt, kvc


@pytest.mark.parametrize("with_kv", [False, True], ids=["tree", "tree+kv"])
@pytest.mark.parametrize("bits", [3, 4])
def test_packed_files_equal_reference(tmp_path, packed, models, bits,
                                      with_kv):
    _save_both(tmp_path, packed, models, bits, with_kv)
    _assert_same_on_disk(tmp_path / "port", tmp_path / "ref")
    meta = _manifest(tmp_path / "port")
    assert ("kv_pages" in meta["paths"]) == with_kv
    assert meta["paths"][0] == ("kv_pages" if with_kv else "other/embed")
    kinds = {p: leaf["dtype"] for p, leaf in zip(meta["paths"],
                                                  meta["leaves"])}
    assert kinds["streams"] == "uint8"
    assert kinds["other/embed"] == "bfloat16"
    assert kinds.get("kv_pages", "uint32") == "uint32"


@pytest.mark.parametrize("with_kv", [False, True], ids=["tree", "tree+kv"])
@pytest.mark.parametrize("bits", [3, 4])
def test_each_package_restores_the_others_checkpoint(tmp_path, packed,
                                                     models, bits, with_kv):
    rt, pt, kvc = _save_both(tmp_path, packed, models, bits, with_kv)
    # the reference's checkpoint, restored by the port
    mgr = CheckpointManager(tmp_path / "ref")
    got, extra = mgr.restore_packed(cache=LayoutCache(), device="cpu")
    assert extra == {"tag": bits}
    assert got.device == torch.device("cpu")
    assert torch.equal(got.streams, pt.streams)
    assert got.manifest == pt.manifest
    _same_tree(got.scales, pt.scales)
    _same_tree(got.packed, pt.packed)
    _same_tree(got.other, pt.other)
    kv = mgr.restore_kv(device="cpu")
    if with_kv:
        assert kv.provenance == "checkpoint"
        assert kv.pages.dtype == torch.int32
        assert torch.equal(kv.pages, kvc.pages)
        assert kv.manifest == kvc.manifest
    else:
        assert kv is None
    # the port's checkpoint, restored by the reference
    ref_mgr = RefMgr(tmp_path / "port")
    back, ref_extra = ref_mgr.restore_packed(cache=RefCache())
    assert ref_extra == {"tag": bits}
    assert np.array_equal(np.asarray(back.streams), np.asarray(rt.streams))
    _same_tree(back.scales, rt.scales)
    _same_tree(back.packed, rt.packed)
    _same_tree(back.other, rt.other)
    ref_kv = ref_mgr.restore_kv()
    if with_kv:
        assert np.array_equal(np.asarray(ref_kv.pages), kvc.host_pages())
    else:
        assert ref_kv is None


def test_verify_packed_reports_like_reference(tmp_path, packed, models):
    _save_both(tmp_path, packed, models, 3, True)
    report = CheckpointManager(tmp_path / "port").verify_packed()
    ref = RefMgr(tmp_path / "port").verify_packed()
    assert report.ok and "kvcache" in report.passes and \
        "manifest" in report.passes
    assert report.to_json_dict() == ref.to_json_dict()


def test_warm_cache_hits_and_cold_cache_never_schedules(tmp_path, packed,
                                                        monkeypatch):
    _rt, pt = packed[3]
    mgr = CheckpointManager(tmp_path)
    mgr.save_packed(0, pt)
    warm = LayoutCache()
    warm.insert(pt.layout().problem, False, pt.layout())
    got, _ = mgr.restore_packed(cache=warm, device="cpu")
    assert got.provenance == "cache-hit"

    def refuse(*args, **kwargs):
        raise AssertionError("restore_packed ran the scheduler")

    from repro_torch import plan as plan_mod
    from repro_torch.core import iris

    monkeypatch.setattr(iris, "schedule", refuse)
    monkeypatch.setattr(plan_mod, "schedule", refuse)
    cold = LayoutCache()
    got, _ = mgr.restore_packed(cache=cold, device="cpu")
    assert got.provenance == "manifest"
    assert torch.equal(got.streams, pt.streams)
    got, _ = mgr.restore_packed(cache=None, device="cpu")
    assert got.provenance == "manifest"
    # the cold cache now holds the layout: the next restore hits
    got, _ = mgr.restore_packed(cache=cold, device="cpu")
    assert got.provenance == "cache-hit"


def _stream_file(root: pathlib.Path) -> pathlib.Path:
    meta = _manifest(root)
    return root / STEP / f"arr_{meta['paths'].index('streams'):05d}.npy"


def _refused(mgr, rule: str) -> None:
    with pytest.raises(AnalysisError) as ei:
        mgr.restore_packed(cache=LayoutCache(), device="cpu")
    assert rule in ei.value.report.rule_ids(), ei.value.report.render()
    assert rule in str(ei.value)


def test_truncated_stream_refused(tmp_path, packed):
    mgr = CheckpointManager(tmp_path)
    mgr.save_packed(0, packed[4][1])
    f = _stream_file(tmp_path)
    np.save(f, np.load(f)[:, :, :-4])
    _refused(mgr, "manifest/stream-shape")
    assert not mgr.verify_packed().ok


def test_bit_flipped_stream_refused_and_verify_false_skips(tmp_path, packed):
    pt = packed[4][1]
    mgr = CheckpointManager(tmp_path)
    mgr.save_packed(0, pt)
    f = _stream_file(tmp_path)
    arr = np.load(f)
    arr.flat[7] ^= np.uint8(0x10)
    np.save(f, arr)
    _refused(mgr, "manifest/stream-digest")
    got, _ = mgr.restore_packed(cache=LayoutCache(), verify=False,
                                device="cpu")
    assert not torch.equal(got.streams, pt.streams)
    assert torch.equal(got.streams, torch.from_numpy(arr))


def test_tampered_signature_refused(tmp_path, packed):
    mgr = CheckpointManager(tmp_path)
    mgr.save_packed(0, packed[3][1])
    meta = _manifest(tmp_path)
    meta["extra"]["packed_tree_manifest"]["signature"][0] += 8
    (tmp_path / STEP / "manifest.json").write_text(json.dumps(meta))
    _refused(mgr, "manifest/signature")


def test_corrupt_kv_pages_refused(tmp_path, packed, models):
    kvc = filled_kv(models[1], 3)
    mgr = CheckpointManager(tmp_path)
    mgr.save_packed(0, packed[3][1], kv=kvc)
    meta = _manifest(tmp_path)
    f = tmp_path / STEP / f"arr_{meta['paths'].index('kv_pages'):05d}.npy"
    pages = np.load(f)
    pages.flat[1] ^= np.uint32(1)
    np.save(f, pages)
    with pytest.raises(AnalysisError) as ei:
        mgr.restore_kv(device="cpu")
    assert "kvcache/pages-digest" in ei.value.report.rule_ids()
    assert not mgr.verify_packed().ok
    assert mgr.restore_kv(verify=False, device="cpu") is not None


def test_save_packed_refuses_a_tree_without_streams(tmp_path, packed):
    pt = packed[3][1]
    bare = PackedTree(pt.packed, pt.scales, pt.other, None, pt.manifest)
    with pytest.raises(ValueError, match="stream buffers"):
        CheckpointManager(tmp_path).save_packed(0, bare)


@pytest.mark.parametrize("bits", [3, 4])
def test_decode_continues_bit_for_bit_after_restore(tmp_path, packed, models,
                                                    bits):
    """3 steps, a snapshot of the tree and the KV pages, then 4 more steps
    from the original state and from the restored tree and cache: the
    logits are equal bit for bit."""
    pcfg = models[1]
    pt = packed[bits][1]
    adapter = PackedAdapter(pcfg, pt, kv="packed", kv_bits=bits)
    state = adapter.init_state(N_SLOTS, MAX_SEQ)
    rng = np.random.default_rng(bits)
    toks = rng.integers(1, pcfg.vocab_size, (7, N_SLOTS))
    slots = torch.arange(N_SLOTS)
    for t in range(3):
        _, state = packed_decode_step(pcfg, pt, state,
                                      torch.from_numpy(toks[t]),
                                      slot_ids=slots, kv="packed")
    mgr = CheckpointManager(tmp_path)
    mgr.save_packed(3, pt, kv=state["packed_kv"])
    tree2, _ = mgr.restore_packed(device="cpu")
    restored = {"pos": state["pos"].clone(),
                "packed_kv": mgr.restore_kv(device="cpu")}
    for t in range(3, 7):
        tok = torch.from_numpy(toks[t])
        want, state = packed_decode_step(pcfg, pt, state, tok,
                                         slot_ids=slots, kv="packed")
        got, restored = packed_decode_step(pcfg, tree2, restored, tok,
                                           slot_ids=slots, kv="packed")
        assert torch.equal(got, want), t
    assert torch.equal(restored["packed_kv"].pages, state["packed_kv"].pages)


def test_entry_points_raise_without_a_card_and_a_device(tmp_path, packed,
                                                        models, monkeypatch):
    port, _ = _dense_trees()
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, port)
    mgr.save_packed(1, packed[3][1], kv=filled_kv(models[1], 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(port, step=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore_packed(step=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore_kv(step=1)
    assert mgr.restore_kv(step=1, device="cpu").device == torch.device("cpu")

