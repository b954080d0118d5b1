"""Admission queue: the engine's front gate.

Own copy of ``src/repro/engine/queue.py`` (pure Python, unchanged).

Requests enter the serving engine through one bounded queue.  Admission
is *explicitly* arbitrated — the queue either accepts a request or
rejects it with a machine-readable reason, so overload shows up as a
backpressure signal instead of unbounded memory growth:

* **bounded backlog** — at most ``max_backlog`` requests wait; the next
  submit is rejected with ``"backlog-full"`` (the caller sheds load or
  retries, the engine never buffers beyond its declared capacity);
* **deadlines** — a request may carry an absolute ``deadline`` (engine
  clock); one that cannot be admitted in time is rejected with
  ``"deadline-expired"``, at submit if already late, or lazily at pop
  when it went stale while waiting — serving a request whose caller has
  given up only burns decode slots;
* **priorities** — higher ``priority`` pops first; ties resolve in
  strict arrival order (FIFO), which is the fairness invariant
  tests/test_engine.py pins with a hypothesis property.

The queue knows nothing about models or slots; the
:class:`~repro.engine.scheduler.Engine` admit stage is its only
consumer, and the rejection log feeds
:class:`~repro.engine.metrics.EngineMetrics`.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Callable

__all__ = ["Admission", "AdmissionQueue", "EngineRequest",
           "REJECT_BACKLOG_FULL", "REJECT_DEADLINE_EXPIRED"]

#: rejection reasons (machine-readable; the metrics layer counts by them)
REJECT_BACKLOG_FULL = "backlog-full"
REJECT_DEADLINE_EXPIRED = "deadline-expired"


@dataclasses.dataclass
class EngineRequest:
    """One generation request.

    The first five fields match the legacy ``runtime.serve_loop.Request``
    dataclass, so pre-engine callers construct these unchanged; the rest
    is engine-level admission/observability state.
    """

    uid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: higher pops first; ties pop in arrival order
    priority: int = 0
    #: absolute engine-clock time by which the request must be *admitted*
    #: into a slot; ``None`` = never expires
    deadline: float | None = None
    #: "created" -> "queued" -> "active" -> "done" | "rejected"
    status: str = "created"
    reject_reason: str | None = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


@dataclasses.dataclass(frozen=True)
class Admission:
    """Result of :meth:`AdmissionQueue.submit` (and engine ``submit``)."""

    accepted: bool
    reason: str | None = None     # rejection reason when not accepted
    backlog: int = 0              # queue depth after the decision

    def __bool__(self) -> bool:
        return self.accepted


class AdmissionQueue:
    """Bounded priority/FIFO admission queue with lazy deadline expiry.

    ``max_backlog=None`` means unbounded (the legacy ``ServeLoop``
    contract); the engine default is bounded.  All timestamps come from
    the injected ``clock`` so tests and simulations can run on virtual
    time.
    """

    def __init__(self, max_backlog: int | None = 64, *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_backlog is not None and max_backlog <= 0:
            raise ValueError(f"max_backlog must be positive, got {max_backlog}")
        self.max_backlog = max_backlog
        self.clock = clock
        self._heap: list[tuple[int, int, EngineRequest]] = []
        self._seq = itertools.count()
        #: (uid, reason) in rejection order — the overflow audit trail
        self.rejections: list[tuple[int, str]] = []
        self.accepted = 0
        self.rejected_by_reason: dict[str, int] = {}

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._heap)

    def _reject(self, req: EngineRequest, reason: str) -> Admission:
        req.status = "rejected"
        req.reject_reason = reason
        self.rejections.append((req.uid, reason))
        self.rejected_by_reason[reason] = \
            self.rejected_by_reason.get(reason, 0) + 1
        return Admission(False, reason, backlog=len(self._heap))

    def submit(self, req: EngineRequest,
               now: float | None = None) -> Admission:
        """Admit ``req`` to the backlog, or reject it with a reason."""
        now = self.clock() if now is None else now
        if req.expired(now):
            return self._reject(req, REJECT_DEADLINE_EXPIRED)
        if self.max_backlog is not None and len(self._heap) >= self.max_backlog:
            return self._reject(req, REJECT_BACKLOG_FULL)
        heapq.heappush(self._heap, (-req.priority, next(self._seq), req))
        req.status = "queued"
        self.accepted += 1
        return Admission(True, backlog=len(self._heap))

    def pop(self, now: float | None = None) -> EngineRequest | None:
        """Highest-priority (then oldest) request that is still in
        deadline; stale requests encountered on the way are rejected."""
        now = self.clock() if now is None else now
        while self._heap:
            _, _, req = heapq.heappop(self._heap)
            if req.expired(now):
                self._reject(req, REJECT_DEADLINE_EXPIRED)
                continue
            return req
        return None

    def drain_expired(self, now: float | None = None) -> int:
        """Proactively reject every stale request; returns the count."""
        now = self.clock() if now is None else now
        keep = [(p, s, r) for p, s, r in self._heap if not r.expired(now)]
        n = len(self._heap) - len(keep)
        for p, s, r in self._heap:
            if r.expired(now):
                self._reject(r, REJECT_DEADLINE_EXPIRED)
        heapq.heapify(keep)
        self._heap = keep
        return n

    def snapshot(self) -> dict:
        return {
            "backlog": len(self._heap),
            "max_backlog": self.max_backlog,
            "accepted": self.accepted,
            "rejected": dict(self.rejected_by_reason),
        }
