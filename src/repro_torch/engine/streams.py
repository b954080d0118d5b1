"""Double-buffered host->device stream uploads on a side CUDA stream.

Port of ``src/repro/engine/streams.py``.  The stream-direct serving path
reads each layer's packed Iris stream as flat u32 words on the device
(``kernels.stream_matmul``).  When the model does not live on the card —
host memory holds the streams, the card a working set — every decode
step must ship each layer's stream up, and done naively the transfer
serializes behind compute.

:class:`BufferRing` is a plain copy of the reference's.
:class:`StreamUploader` keeps the reference's contract: buffers keyed by
``(manifest signature, layer)`` (trees sharing a signature share
entries), ``__call__(layer)`` hands out that layer's device words and
prefetches ``layer + 1``, the ring holds ``depth`` (default 2) buffers,
the same :meth:`~StreamUploader.stats` keys, and it is a context manager.

Where the reference runs ``jax.device_put`` on a worker thread, the
uploader runs each upload on a **side CUDA stream**: a ``non_blocking``
copy from the tree's pinned host words
(:meth:`~repro_torch.tree.PackedTree.host_stream_words`), followed by an
event.  ``__call__`` makes the caller's current stream wait on that event
before it hands the words out, and records the buffer on that stream, so
a buffer evicted from the ring is not reused by the allocator while a
matmul still reads it.  The copy of layer ``L + 1`` thus runs under the
compute of layer ``L``.  For a tree on the CPU an upload is a plain copy.
The words handed out are always the uploaded copy, never the tree's
resident buffer.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any

import torch

__all__ = ["BufferRing", "StreamUploader"]


class BufferRing:
    """FIFO ring of at most ``depth`` in-flight keyed buffers.

    Inserting beyond capacity evicts the oldest entry (its device buffer
    is dropped and garbage-collected).  ``get`` does not consume — the
    current layer's buffer stays resident while the next one uploads.
    """

    def __init__(self, depth: int = 2) -> None:
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self.depth = depth
        self._entries: OrderedDict[Any, Any] = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Any) -> bool:
        return key in self._entries

    def get(self, key: Any) -> Any | None:
        return self._entries.get(key)

    def put(self, key: Any, value: Any) -> None:
        if key in self._entries:
            self._entries[key] = value
            self._entries.move_to_end(key)
            return
        self._entries[key] = value
        while len(self._entries) > self.depth:
            self._entries.popitem(last=False)
            self.evictions += 1

    def keys(self) -> list[Any]:
        return list(self._entries)


class StreamUploader:
    """Double-buffered host->device uploader over a ``PackedTree``.

    The words go to the tree's device, where its kernels read them (the
    reference's ``device_put`` argument has no other use here).  On a
    CUDA device every upload runs on one side stream (:attr:`stream`), in
    order, overlapping the caller's compute.
    """

    def __init__(self, tree, *, depth: int = 2) -> None:
        if tree.streams is None:
            raise ValueError(
                "tree was built with with_streams=False; stream uploads "
                "need the host stream buffers"
            )
        self.tree = tree
        self.n_layers = tree.manifest.n_layers
        #: ring keys lead with the manifest signature: trees sharing a
        #: layout signature share entries
        self._sig = tree.manifest.signature
        self.ring = BufferRing(depth)
        self.device = tree.device
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # counters (consumed by EngineMetrics via the engine)
        self.uploads = 0
        self.bytes_uploaded = 0
        self.prefetch_hits = 0
        self.sync_fetches = 0

    # ------------------------------------------------------------------
    def _upload(self, layer: int) -> tuple[torch.Tensor, Any]:
        """Enqueue layer ``layer``'s copy: ``(device words, done event)``
        (the event is None on the CPU, where the copy is done)."""
        words = self.tree.host_stream_words(layer)
        if self.stream is None:
            out = (words.to(self.device, copy=True), None)
        else:
            with torch.cuda.stream(self.stream):
                buf = words.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            out = (buf, done)
        self.uploads += 1
        self.bytes_uploaded += words.numel() * words.element_size()
        return out

    def prefetch(self, layer: int) -> None:
        """Enqueue layer ``layer``'s upload (idempotent while the buffer
        is still in the ring)."""
        layer = layer % self.n_layers
        key = (self._sig, layer)
        if key not in self.ring:
            self.ring.put(key, self._upload(layer))

    def __call__(self, layer: int) -> torch.Tensor:
        """Device words for ``layer`` — the engine's ``stream_source``.

        Uploads now if the buffer was never prefetched (cold start / ring
        evicted); the caller's current stream waits for the copy on the
        device, not on the host.  Before returning, enqueues ``layer+1``
        so its transfer rides under the caller's compute for this layer.
        """
        layer = layer % self.n_layers
        key = (self._sig, layer)
        entry = self.ring.get(key)
        if entry is None:
            self.sync_fetches += 1
            entry = self._upload(layer)
            self.ring.put(key, entry)
        else:
            self.prefetch_hits += 1
        buf, done = entry
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            buf.record_stream(current)
        if self.n_layers > 1:
            self.prefetch(layer + 1)
        return buf

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "uploads": self.uploads,
            "bytes_uploaded": self.bytes_uploaded,
            "prefetch_hits": self.prefetch_hits,
            "sync_fetches": self.sync_fetches,
            "ring_depth": self.ring.depth,
            "ring_evictions": self.ring.evictions,
        }

    def close(self) -> None:
        """Wait for every enqueued upload to finish."""
        if self.stream is not None:
            self.stream.synchronize()

    def __enter__(self) -> "StreamUploader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
