"""Per-request serving metrics: the observability layer of the engine.

Own copy of ``src/repro/engine/metrics.py`` (pure Python, unchanged).

Every request is timed through four phases on the engine clock —

    submit --queue--> admit --prefill--> first_token --decode--> complete
      \\_________________________ total _________________________/

and the registry aggregates p50/p99/mean per phase plus engine-level
throughput counters (tokens/s, steps/s, stream-bytes/s).  The snapshot
is a plain JSON-able dict: ``benchmarks/bench_serve.py`` writes it into
``BENCH_serve.json``, ``launch/serve.py --metrics-out`` dumps it to a
file, and later PRs benchmark against the same schema.

Pure Python on purpose: no numpy/jax import, so the metrics layer rides
along anywhere the queue does (including the non-model hypothesis tests).
"""
from __future__ import annotations

import json
import time
from typing import Callable

__all__ = ["EngineMetrics", "RequestTiming", "percentile"]


def percentile(values: list[float], p: float) -> float:
    """Linear-interpolated percentile (numpy's default), ``p`` in [0, 100].

    Returns ``0.0`` for an empty sample so snapshots of an idle engine
    stay well-formed.
    """
    if not values:
        return 0.0
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class RequestTiming:
    """Phase timestamps of one request (engine-clock seconds)."""

    __slots__ = ("uid", "submitted", "admitted", "first_token", "completed",
                 "n_tokens")

    def __init__(self, uid: int, submitted: float) -> None:
        self.uid = uid
        self.submitted = submitted
        self.admitted: float | None = None
        self.first_token: float | None = None
        self.completed: float | None = None
        self.n_tokens = 0

    # -- phase latencies (None until the closing timestamp lands) ------
    @property
    def queue_s(self) -> float | None:
        if self.admitted is None:
            return None
        return self.admitted - self.submitted

    @property
    def prefill_s(self) -> float | None:
        """Admission to first sampled token (prompt consumption)."""
        if self.first_token is None or self.admitted is None:
            return None
        return self.first_token - self.admitted

    @property
    def decode_s(self) -> float | None:
        if self.completed is None or self.first_token is None:
            return None
        return self.completed - self.first_token

    @property
    def total_s(self) -> float | None:
        if self.completed is None:
            return None
        return self.completed - self.submitted


class EngineMetrics:
    """Aggregating registry the engine stages report into."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self.timings: dict[int, RequestTiming] = {}
        self.rejections: dict[str, int] = {}
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.rejected = 0
        self.steps = 0
        self.active_row_steps = 0        # sum over steps of active slots
        self.tokens_generated = 0
        self.stream_bytes = 0            # host->device stream upload bytes
        self.uploader_stats: dict = {}   # latest StreamUploader.stats()
        self._t0: float | None = None    # first submit (throughput window)
        self._t_last: float | None = None

    # -- recording hooks (one per engine stage event) -------------------
    def _touch(self, now: float) -> None:
        if self._t0 is None:
            self._t0 = now
        self._t_last = now

    def record_submit(self, uid: int, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        self._touch(now)
        self.timings[uid] = RequestTiming(uid, now)
        self.submitted += 1

    def record_reject(self, uid: int, reason: str,
                      now: float | None = None) -> None:
        now = self.clock() if now is None else now
        self._touch(now)
        self.rejections[reason] = self.rejections.get(reason, 0) + 1
        self.rejected += 1
        self.timings.pop(uid, None)      # rejected requests have no latency

    def record_admit(self, uid: int, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        self._touch(now)
        t = self.timings.get(uid)
        if t is not None and t.admitted is None:
            t.admitted = now
        self.admitted += 1

    def record_first_token(self, uid: int, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        self._touch(now)
        t = self.timings.get(uid)
        if t is not None and t.first_token is None:
            t.first_token = now

    def record_token(self, uid: int) -> None:
        self.tokens_generated += 1
        t = self.timings.get(uid)
        if t is not None:
            t.n_tokens += 1

    def record_complete(self, uid: int, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        self._touch(now)
        t = self.timings.get(uid)
        if t is not None and t.completed is None:
            t.completed = now
        self.completed += 1

    def record_step(self, n_active: int) -> None:
        self.steps += 1
        self.active_row_steps += n_active

    def record_stream_bytes(self, n: int) -> None:
        self.stream_bytes += n

    def record_uploader_stats(self, stats: dict) -> None:
        """Latest :meth:`StreamUploader.stats` counters (cumulative on
        the uploader side, so last-write-wins is the right merge)."""
        self.uploader_stats = dict(stats)

    # -- aggregation ----------------------------------------------------
    def _phase(self, attr: str) -> dict:
        xs = [getattr(t, attr) for t in self.timings.values()
              if getattr(t, attr) is not None]
        return {
            "n": len(xs),
            "p50_s": percentile(xs, 50),
            "p99_s": percentile(xs, 99),
            "mean_s": (sum(xs) / len(xs)) if xs else 0.0,
            "max_s": max(xs) if xs else 0.0,
        }

    def snapshot(self, now: float | None = None) -> dict:
        """The JSON-able metrics report (schema documented in DESIGN.md
        §Serving-engine).  ``elapsed_s`` spans first submit -> ``now``."""
        now = self.clock() if now is None else now
        t0 = self._t0 if self._t0 is not None else now
        elapsed = max(now - t0, 1e-9)
        batch = (self.active_row_steps / self.steps) if self.steps else 0.0
        return {
            "requests": {
                "submitted": self.submitted,
                "admitted": self.admitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "rejected_by_reason": dict(self.rejections),
            },
            "latency": {
                "queue": self._phase("queue_s"),
                "prefill": self._phase("prefill_s"),
                "decode": self._phase("decode_s"),
                "total": self._phase("total_s"),
            },
            "throughput": {
                "elapsed_s": elapsed,
                "steps": self.steps,
                "steps_per_s": self.steps / elapsed,
                "tokens_generated": self.tokens_generated,
                "tokens_per_s": self.tokens_generated / elapsed,
                "goodput_tokens_per_s": sum(
                    t.n_tokens for t in self.timings.values()
                    if t.completed is not None) / elapsed,
                "mean_batch_occupancy": batch,
                "stream_bytes": self.stream_bytes,
                "stream_bytes_per_s": self.stream_bytes / elapsed,
                "uploader": dict(self.uploader_stats),
            },
        }

    def to_json(self, path: str | None = None, now: float | None = None,
                ) -> str:
        text = json.dumps(self.snapshot(now), indent=2) + "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text
