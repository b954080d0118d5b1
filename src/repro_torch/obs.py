"""Spans and counters of the port's own work: one recorder, off by default.

    from repro_torch import obs

    obs.enable()
    with obs.span("model_step", rows=64):
        ...
    obs.count("logits_copy_bytes", n)
    rec = obs.collect()          # Record(spans=[Span, ...], counts={...})
    obs.disable()
    obs.reset()

Off (the default), :func:`span` returns one shared null context after a
single check of a module global, and :func:`count` returns at once:
neither calls into torch, so a span left in the served path costs it a
fraction of a microsecond.  On, a span records its name, its parent (the
span open around it), its attributes, and its start and end on
:func:`time.perf_counter_ns`; a counter keeps a running total.  Spans
nest as the one thread that serves opens them.  At most
:data:`MAX_SPANS` spans are kept until :func:`reset`; later ones are
counted in ``Record.dropped`` and not recorded.

While a ``torch.profiler`` also runs, each span opens
``record_function("repro.<name>")`` as well.  That puts the span in the
profiler's own event list, on the clock of the device operations the
profiler records: a kernel links to the span its launch was made in
through the launch's correlation id, and a device idle gap to the span
the host was in.

The spans of the port (name: where):

- ``engine.admit``, ``engine.prefill``, ``engine.decode``,
  ``engine.retire``: the stages of :meth:`Engine.step
  <repro_torch.engine.Engine.step>`, each with the engine's ``step``
  index (the sampler runs inside ``engine.retire``);
- ``model_step``: :meth:`PackedAdapter.step
  <repro_torch.engine.PackedAdapter.step>`, with its child
  ``logits_copy`` (the logits to the host) and the counter
  ``logits_copy_bytes``;
- ``matmul.stream`` / ``matmul.packed`` (one a weight matmul, by kind),
  ``kv_append`` (:meth:`PackedKVCache.append
  <repro_torch.kvcache.PackedKVCache.append>`), ``attention`` and
  ``logits`` (final norm and unembedding) inside
  :func:`~repro_torch.models.quantized.packed_decode_step`;
- set-up: ``lower_exec`` (a layout lowered, not a memo hit).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = ["MAX_SPANS", "Record", "Span", "collect", "count", "disable",
           "enable", "reset", "span"]

#: spans kept between resets: a served step records ~300, set-up a few
#: hundred, so this holds hundreds of traced steps
MAX_SPANS = 1 << 17


@dataclasses.dataclass(eq=False, slots=True)
class Span:
    """One recorded span; ``end_ns`` is 0 while it is open."""

    name: str
    attrs: dict
    parent: "Span | None"
    start_ns: int
    end_ns: int = 0

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def path(self) -> str:
        """The names from the outermost enclosing span down to this one,
        joined by ``/``."""
        names, s = [], self
        while s is not None:
            names.append(s.name)
            s = s.parent
        return "/".join(reversed(names))


@dataclasses.dataclass
class Record:
    """What :func:`collect` returns: the spans in the order they opened,
    the counters, and the spans not kept for want of room."""

    spans: list[Span]
    counts: dict[str, int]
    dropped: int


_on = False
_spans: list[Span] = []
_counts: dict[str, int] = {}
_dropped = 0
_top: Span | None = None            # the innermost open span
_NULL = contextlib.nullcontext()


class _Open:
    """The context of one span while recording is on."""

    __slots__ = ("name", "attrs", "span", "prev", "rf")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Open":
        global _dropped, _top
        import torch

        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(
                "repro." + self.name)
            self.rf.__enter__()
        self.prev = _top
        self.span = None
        if len(_spans) < MAX_SPANS:
            self.span = Span(self.name, self.attrs, self.prev,
                             time.perf_counter_ns())
            _spans.append(self.span)
            _top = self.span
        else:
            _dropped += 1
        return self

    def __exit__(self, *exc) -> bool:
        global _top
        if self.span is not None:
            self.span.end_ns = time.perf_counter_ns()
            _top = self.prev
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` with ``attrs`` while
    recording is on; the shared null context while it is off."""
    if not _on:
        return _NULL
    return _Open(name, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while recording is on."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def collect() -> Record:
    """The spans and counters recorded since the last :func:`reset`."""
    return Record(list(_spans), dict(_counts), _dropped)


def reset() -> None:
    """Forget every span and counter (recording stays on or off)."""
    global _dropped
    _spans.clear()
    _counts.clear()
    _dropped = 0
