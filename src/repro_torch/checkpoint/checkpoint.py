"""Checkpoints: atomic, async, keep-N; packed trees with their KV pages.

Own copy of ``src/repro/checkpoint/checkpoint.py`` for the port, over
PyTorch tensors.  The on-disk format is the reference's, byte for byte,
so a checkpoint written by either package restores in the other:

    <root>/step_000100.tmp-<nonce>/   # written here first
    <root>/step_000100/               # atomic rename when complete
        manifest.json                 # paths, shapes, dtypes, extra
        arr_00000.npy ...             # one file per leaf (host numpy)

Leaves are numbered in ``jax.tree_util`` order, which :func:`_flatten`
reproduces over dicts (sorted keys), lists and tuples (in order) and
``None`` (no leaves).  A bf16 leaf is stored as its ``uint16`` bits with
``"dtype": "bfloat16"`` in the manifest, as the reference stores it, and
comes back as a bf16 tensor through that view (no ``ml_dtypes``).  The
reference's serialized ``treedef`` is written as ``null``: nothing reads
it.  Restores place every leaf on ``device`` (``"cuda"`` unless given);
the reference's ``shardings`` placement waits for the launch tooling.

``save_async`` snapshots every leaf to host memory synchronously and
writes on a daemon thread; a failure there is raised by ``wait()``.

Packed checkpoints (:meth:`CheckpointManager.save_packed`) store exactly
the bytes a :class:`~repro_torch.tree.PackedTree` keeps on the card —
each layer's Iris stream and the unquantized leaves — with its
:class:`~repro_torch.tree.LayoutManifest` and a sha256 of the streams,
and optionally the pages of a :class:`~repro_torch.kvcache.PackedKVCache`
(stored as ``uint32`` words, the reference's dtype; the port keeps them
as an int32 tensor).  :meth:`~CheckpointManager.restore_packed` gates on
the static analyzer (:func:`repro_torch.analysis.verify_manifest`) over
the host arrays it loaded, before anything moves to the card, then
decodes each layer on the card (:func:`repro_torch.tree.unpack_streams`).
"""
from __future__ import annotations

import json
import os
import pathlib
import queue
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..core.iris import DEFAULT_CACHE
from ..device import resolve_device


def _flatten(tree: Any) -> list:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, lists and
    tuples in order, ``None`` a node without leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _tree_paths(tree: Any, prefix: tuple = ()) -> list[str]:
    """``/``-joined key path of each leaf, in :func:`_flatten` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _tree_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _tree_paths(v, prefix + (str(i),))]
    return ["/".join(prefix)]


def _map(fn, tree: Any) -> Any:
    """``fn`` over every leaf, keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _skeletonize(tree: Any) -> tuple[Any, list]:
    """Replace every leaf with ``{"__leaf__": i}``; return (skeleton, leaves).

    The skeleton is plain JSON (dict/list/None), so a checkpoint can
    rebuild the exact tree structure without a ``like`` template — keys
    containing ``/`` (e.g. ``"attn/bq"``) stay unambiguous, unlike
    path-string encodings.
    """
    counter = iter(range(len(_flatten(tree))))

    def skel(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: skel(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [skel(v) for v in node]
        return {"__leaf__": next(counter)}
    return skel(tree), _flatten(tree)


def _unskeletonize(skeleton: Any, leaves: list) -> Any:
    if isinstance(skeleton, dict) and "__leaf__" in skeleton:
        return leaves[skeleton["__leaf__"]]
    if isinstance(skeleton, dict):
        return {k: _unskeletonize(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_unskeletonize(v, leaves) for v in skeleton]
    return skeleton


def _unflatten(like: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`_flatten` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _snapshot(x: Any) -> Any:
    """A leaf copied to host memory now (the caller may mutate it later)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _stored(x: Any) -> tuple[np.ndarray, str]:
    """A host leaf as the array written to disk and its manifest dtype.
    bf16 (and any other dtype numpy cannot save) is stored as its
    unsigned-int bits, as the reference stores it."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    name = str(x.dtype)
    if x.dtype.kind not in "biufc":
        x = x.view(f"u{x.dtype.itemsize}")
    return x, name


def _loaded(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf read from disk as a CPU tensor of its manifest dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype)
    if arr.dtype != want:
        arr = arr.view(want)
    return torch.from_numpy(np.ascontiguousarray(arr))


class CheckpointManager:
    def __init__(self, root: str | os.PathLike, keep_n: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._errors: list[str] = []

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        """Synchronous atomic save.  Returns the final directory path."""
        return self._write(step, _map(_snapshot, tree), extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: dict | None = None) -> None:
        """Snapshot to host now, serialize in the background."""
        host_tree = _map(_snapshot, tree)
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        self._q.put((step, host_tree, dict(extra or {})))

    def wait(self) -> None:
        """Block until all queued async saves are on disk."""
        self._q.join()
        if self._errors:
            errs, self._errors = self._errors, []
            raise RuntimeError("async checkpoint failures: " + "; ".join(errs))

    def _drain(self) -> None:
        while True:
            step, tree, extra = self._q.get()
            try:
                self._write(step, tree, extra)
            except Exception as e:  # noqa: BLE001
                self._errors.append(f"step {step}: {e!r}")
            finally:
                self._q.task_done()

    def _write(self, step: int, host_tree: Any, extra: dict) -> str:
        final = self.root / f"step_{step:08d}"
        tmp = self.root / f"step_{step:08d}.tmp-{os.getpid()}-{time.time_ns()}"
        tmp.mkdir(parents=True)
        stored = [_stored(x) for x in _flatten(host_tree)]
        manifest = {
            "step": step,
            "treedef": None,
            "paths": _tree_paths(host_tree),
            "leaves": [
                {"file": f"arr_{i:05d}.npy", "shape": list(x.shape),
                 "dtype": dtype} for i, (x, dtype) in enumerate(stored)
            ],
            "extra": extra,
        }
        for i, (x, _) in enumerate(stored):
            np.save(tmp / f"arr_{i:05d}.npy", x)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)        # atomicity: readers only see complete dirs
        self._gc()
        return str(final)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)
        # drop stale tmp dirs from crashed writers
        for p in self.root.glob("step_*.tmp-*"):
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.name.endswith(".json") or ".tmp-" in p.name:
                continue
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int | None) -> pathlib.Path:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return self.root / f"step_{step:08d}"

    def restore(self, like: Any, step: int | None = None, *,
                device=None) -> tuple[Any, dict]:
        """Restore into the structure of ``like``, every leaf on
        ``device`` (``"cuda"`` unless given).  Returns (tree, extra)."""
        device = resolve_device(device)
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        like_leaves = _flatten(like)
        if len(like_leaves) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"target structure has {len(like_leaves)}")
        out = []
        for i, (meta, tgt) in enumerate(zip(manifest["leaves"], like_leaves)):
            leaf = _loaded(np.load(d / meta["file"]), meta["dtype"])
            want_shape = tuple(getattr(tgt, "shape", leaf.shape))
            if tuple(leaf.shape) != want_shape:
                raise ValueError(
                    f"leaf {manifest['paths'][i]}: checkpoint shape "
                    f"{tuple(leaf.shape)} != target {want_shape}")
            out.append(leaf.to(device))
        return _unflatten(like, out), manifest["extra"]

    # ------------------------------------------------------------------
    # packed checkpoints: the stream on the card *is* the checkpoint
    # ------------------------------------------------------------------
    _PACKED_KEY = "packed_tree_manifest"
    _SKELETON_KEY = "packed_tree_skeleton"
    _DIGEST_KEY = "packed_stream_sha256"
    _KV_KEY = "packed_kv_manifest"
    _KV_DIGEST_KEY = "packed_kv_sha256"

    def save_packed(self, step: int, pt: Any,
                    extra: dict | None = None, *,
                    kv: Any = None) -> str:
        """Save a :class:`~repro_torch.tree.PackedTree` — packed bytes only.

        What hits disk is the per-layer unified Iris stream buffers
        (exactly the bytes that live on the card) plus the unquantized
        leaves; dense weights are never materialized and the lane-packed
        kernel views are not duplicated (restore rebuilds them bit for
        bit from the streams).  The tree's manifest rides in the
        checkpoint manifest JSON, so restore *rebinds* the layout instead
        of re-scheduling.

        ``kv`` (optional): a :class:`~repro_torch.kvcache.PackedKVCache`
        — its page words are saved beside the weight streams, as
        ``uint32``, with their own manifest and content digest, so a
        serving snapshot taken mid-stream round-trips (:meth:`restore_kv`)
        and decode continues bit for bit.
        """
        if pt.streams is None:
            raise ValueError(
                "PackedTree was built with with_streams=False; packed "
                "checkpointing needs the stream buffers"
            )
        from ..analysis import stream_sha256

        payload = {"streams": pt.streams, "other": pt.other}
        if kv is not None:
            payload["kv_pages"] = kv.host_pages()
        host = _map(_snapshot, payload)
        skeleton, _ = _skeletonize(host)
        merged = dict(extra or {})
        merged[self._PACKED_KEY] = pt.manifest.to_json_dict()
        merged[self._SKELETON_KEY] = skeleton
        # content digest of the stream bytes: layout tables cannot see
        # bit-flips, so restore verifies the bytes themselves
        merged[self._DIGEST_KEY] = stream_sha256(host["streams"].numpy())
        if kv is not None:
            merged[self._KV_KEY] = kv.manifest.to_json_dict()
            merged[self._KV_DIGEST_KEY] = stream_sha256(host["kv_pages"])
        return self._write(step, host, merged)

    def _load_packed(self, step: int | None):
        """Load a packed checkpoint's pieces without rebinding anything.

        Returns ``(tree_manifest, payload, extra, digest, kv_manifest,
        kv_digest)`` where ``payload`` holds the leaves as CPU tensors
        (``streams`` / ``other`` / optionally ``kv_pages``, as stored:
        uint32), ``digest`` is the recorded stream sha256 (``None`` for a
        checkpoint from before digests were stored), and the kv pair is
        the raw :class:`~repro_torch.kvcache.KVManifest` JSON dict and
        page digest (both ``None`` when the checkpoint carries no KV
        pages).
        """
        from ..tree import LayoutManifest

        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        extra = dict(manifest["extra"])
        if self._PACKED_KEY not in extra:
            raise ValueError(
                f"{d.name} is not a packed checkpoint; use restore()"
            )
        tree_manifest = LayoutManifest.from_json_dict(
            extra.pop(self._PACKED_KEY))
        skeleton = extra.pop(self._SKELETON_KEY)
        digest = extra.pop(self._DIGEST_KEY, None)
        kv_manifest = extra.pop(self._KV_KEY, None)
        kv_digest = extra.pop(self._KV_DIGEST_KEY, None)
        leaves = [_loaded(np.load(d / meta["file"]), meta["dtype"])
                  for meta in manifest["leaves"]]
        payload = _unskeletonize(skeleton, leaves)
        return tree_manifest, payload, extra, digest, kv_manifest, kv_digest

    def verify_packed(self, step: int | None = None):
        """Statically verify a packed checkpoint **without restoring it**.

        Runs the :mod:`repro_torch.analysis` manifest-consistency pass set
        over the stored manifest, intervals, stream byte-lengths and
        content digest; returns the report (never raises on findings —
        :meth:`restore_packed` is the one that refuses).  When the
        checkpoint carries KV pages, the KV-cache pass set runs too and
        its findings merge into the same report.  Everything runs on the
        host.
        """
        from ..analysis import verify_manifest

        tree_manifest, payload, _extra, digest, kv_man, kv_digest = \
            self._load_packed(step)
        report = verify_manifest(
            tree_manifest, streams=payload["streams"].numpy(),
            stream_digest=digest,
            subject=f"ckpt[{self.root.name}/{tree_manifest.arch}]")
        if kv_man is not None:
            sub = self._verify_kv(payload, kv_man, kv_digest)
            report.findings.extend(sub.findings)
            report.passes.extend(p for p in sub.passes
                                 if p not in report.passes)
        return report

    def _rebuild_kv(self, payload: dict, kv_man: dict, device):
        """Stored KV pieces -> a :class:`PackedKVCache` on ``device``."""
        from ..kvcache import KVManifest, PackedKVCache

        pages = payload["kv_pages"].numpy().view(np.int32)
        return PackedKVCache(torch.from_numpy(pages).to(device),
                             KVManifest.from_json_dict(kv_man),
                             provenance="checkpoint")

    def _verify_kv(self, payload: dict, kv_man: dict,
                   kv_digest: str | None):
        from ..analysis import Finding, Report, Severity, verify_kvcache

        if "kv_pages" not in payload:
            r = Report(subject=f"ckpt[{self.root.name}/kv]")
            r.findings.append(Finding(
                "kvcache/pages-missing", Severity.ERROR,
                "checkpoint records a KV manifest but stores no "
                "kv_pages leaf"))
            return r
        return verify_kvcache(
            self._rebuild_kv(payload, kv_man, torch.device("cpu")),
            pages_digest=kv_digest, subject=f"ckpt[{self.root.name}/kv]")

    def restore_packed(self, step: int | None = None, *,
                       cache: Any = DEFAULT_CACHE, verify: bool = True,
                       device=None) -> tuple[Any, dict]:
        """Restore a :class:`~repro_torch.tree.PackedTree` on ``device``
        (``"cuda"`` unless given) from a packed save.

        Before anything moves to the device, the static analyzer proves
        the checkpoint self-consistent on the host arrays it loaded
        (manifest vs bundle vs intervals vs stream byte-lengths vs
        content digest); a corrupted checkpoint raises
        :class:`~repro_torch.analysis.AnalysisError` naming the violated
        rule (``verify=False`` skips, for forensics on a checkpoint the
        analyzer already rejected).  The layout comes from ``cache`` when
        warm or from the manifest's count-intervals when cold (the
        scheduler never runs), and each layer's stream is decoded by the
        fused decode kernel on the device, one launch a layer.  Returns
        ``(PackedTree, extra)`` with the packed bookkeeping keys stripped
        from ``extra``.
        """
        from ..tree import unpack_streams

        device = resolve_device(device)
        tree_manifest, payload, extra, digest, _kv_man, _kv_digest = \
            self._load_packed(step)
        if verify:
            from ..analysis import verify_manifest

            verify_manifest(
                tree_manifest, streams=payload["streams"].numpy(),
                stream_digest=digest,
                subject=f"ckpt[{self.root.name}]").raise_if_errors()
        other = _map(lambda t: t.to(device), payload["other"])
        pt = unpack_streams(tree_manifest, payload["streams"], other,
                            cache=cache, device=device)
        return pt, extra

    def restore_kv(self, step: int | None = None, *,
                   verify: bool = True, device=None) -> Any:
        """Restore the :class:`~repro_torch.kvcache.PackedKVCache` a
        packed checkpoint carries (``save_packed(..., kv=...)``), its
        pages on ``device`` (``"cuda"`` unless given) and its
        ``provenance`` ``"checkpoint"``.

        Returns ``None`` when the checkpoint has no KV pages.  With
        ``verify=True`` the KV-cache analysis pass set must come back
        clean on the host (page geometry, content digest, write-mask
        soundness, append idempotence) before the cache is handed out.
        """
        device = resolve_device(device)
        _man, payload, _extra, _digest, kv_man, kv_digest = \
            self._load_packed(step)
        if kv_man is None:
            return None
        if verify:
            self._verify_kv(payload, kv_man, kv_digest).raise_if_errors()
        return self._rebuild_kv(payload, kv_man, device)
