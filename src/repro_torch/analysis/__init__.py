"""repro_torch.analysis — static layout verifier and bandwidth-efficiency lint.

Own copy of ``src/repro/analysis/__init__.py`` for the port.  The passes
work on host numpy, as the reference's do: an entry point that is handed
a tree or a cache on the card makes one host copy of its streams or
pages first.  The one rule that differs from the reference's is in
:mod:`~repro_torch.analysis.passes` (no ``extraction/host-fallback``).

The paper treats a data layout as a provable object: every element's bit
interval is statically known, so unsoundness (overlap, gaps, OOB words,
illegal extractions) and inefficiency (wasted bus bits, padding) are
decidable **without executing anything**.  This package is that checker:
a pass-based analyzer over :class:`~repro_torch.core.layout.Layout`,
:class:`~repro_torch.core.exec_plan.ExecProgram`, stream tables and
:class:`~repro_torch.tree.LayoutManifest`, reporting structured
:class:`Finding` objects instead of asserting.

Entry points (all return a :class:`Report`; none raises unless asked):

* :func:`verify_layout` — schedule-level + lowered-table proof for one
  layout (``Plan.verify()`` routes here).
* :func:`verify_program` — lowered tables only, no re-lowering; what the
  mutation harness drives (a corrupted table must not be "fixed" by
  re-deriving it).
* :func:`verify_manifest` — checkpoint-grade consistency: manifest vs
  bundle vs intervals vs stream byte-lengths vs content digest
  (``restore_packed`` runs this before rebinding).
* :func:`verify_tree` — a whole :class:`~repro_torch.tree.PackedTree`
  (``PackedTree.verify()`` routes here).
* :func:`verify_kvcache` — a :class:`~repro_torch.kvcache.PackedKVCache`:
  layout + tables proof plus the mutable-stream checks (token write-mask
  disjointness/coverage, page geometry and digest, per-page append
  idempotence).  ``PackedKVCache.verify()`` routes here, and
  ``verify_packed``/``restore_kv`` on the checkpoint manager extend the
  gate to KV pages stored on disk.

Manifests, trees and caches are consumed duck-typed; nothing here
launches a kernel, so the CLI and the gate run without a card.
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from ..core.exec_plan import ExecProgram, lower_exec
from ..core.layout import Layout

from .findings import AnalysisError, Finding, Report, Severity
from .passes import (
    DEFAULT_B_EFF_WARN,
    DEFAULT_PAD_WARN,
    PASSES,
    AnalysisContext,
    run_passes,
    stream_sha256,
)

__all__ = [
    "AnalysisContext", "AnalysisError", "Finding", "Report", "Severity",
    "PASSES", "run_passes", "stream_sha256",
    "DEFAULT_B_EFF_WARN", "DEFAULT_PAD_WARN",
    "LAYOUT_ONLY_PASSES", "KVCACHE_PASSES",
    "verify_layout", "verify_layout_fast", "verify_program",
    "verify_manifest", "verify_tree", "verify_kvcache",
]

#: Passes that consume the layout alone — no ExecProgram, no lowering.
LAYOUT_ONLY_PASSES: tuple[str, ...] = ("interval", "bandwidth")

#: Passes a packed KV-cache runs: the weight-tree ``manifest`` pass is
#: replaced by the KV-specific one (a KVManifest has no count-intervals
#: or quant-group shapes to check).
KVCACHE_PASSES: tuple[str, ...] = (
    "interval", "program", "kernel", "stream", "extraction", "bandwidth",
    "kvcache",
)


def verify_layout_fast(layout: Layout, *, subject: str = "",
                       b_eff_warn: float = DEFAULT_B_EFF_WARN) -> Report:
    """Layout-only verification: the interval-legality and bandwidth
    passes, skipping exec lowering entirely.

    Lowering costs seconds on model-scale layouts; this path is
    O(intervals) and is what the reference's persistent layout-cache
    tier runs on every load before an entry is trusted (millisecond
    budget per signature).
    """
    ctx = AnalysisContext(layout=layout, b_eff_warn=b_eff_warn)
    return run_passes(ctx, LAYOUT_ONLY_PASSES, subject=subject or "layout")


def verify_layout(layout: Layout, *,
                  program: ExecProgram | None = None,
                  elem_widths: tuple[int, ...] | None = None,
                  passes: Iterable[str] | None = None,
                  subject: str = "",
                  b_eff_warn: float = DEFAULT_B_EFF_WARN) -> Report:
    """Statically verify one layout and its lowered tables.

    Lowers the layout (memoized on it) unless ``program`` is supplied.
    A layout that cannot even be lowered is itself a finding
    (``program/lowering``), not an exception.
    """
    report = Report(subject=subject or "layout")
    if program is None:
        try:
            program = lower_exec(layout, elem_widths)
        except (ValueError, AssertionError) as e:
            report.findings.append(Finding(
                "program/lowering", Severity.ERROR,
                f"layout does not lower to an ExecProgram: {e}"))
    ctx = AnalysisContext(layout=layout, program=program,
                          b_eff_warn=b_eff_warn)
    sub = run_passes(ctx, passes, subject=report.subject)
    report.findings.extend(sub.findings)
    report.passes = sub.passes
    return report


def verify_program(program: ExecProgram, *,
                   layout: Layout | None = None,
                   passes: Iterable[str] | None = None,
                   subject: str = "") -> Report:
    """Verify lowered tables as-is — no re-lowering, no repair.

    The mutation harness drives this: a corrupted table must be judged
    on its own contents.  ``layout`` (optional) adds array names and the
    interval/coverage/bandwidth checks.
    """
    ctx = AnalysisContext(layout=layout, program=program)
    return run_passes(ctx, passes, subject=subject or "program")


def verify_manifest(manifest: Any, *,
                    streams: np.ndarray | None = None,
                    stream_digest: str | None = None,
                    passes: Iterable[str] | None = None,
                    subject: str = "") -> Report:
    """Checkpoint-grade verification of a :class:`LayoutManifest`.

    Rebuilds the layout from the manifest's recorded count-intervals and
    runs the full pass set over it; a manifest too corrupt to yield a
    layout (bad bundle, bad signature, illegal intervals) degrades to
    manifest-pass findings instead of raising.  ``streams`` /
    ``stream_digest`` extend the proof to the stored bytes.
    """
    subject = subject or f"manifest[{getattr(manifest, 'arch', '?')}]"
    report = Report(subject=subject)
    layout = program = None
    try:
        prob = manifest.problem()
        if prob.canonical_signature() == manifest.signature:
            layout = Layout.from_count_intervals(prob, manifest.intervals)
    except (ValueError, AssertionError, TypeError):
        # the manifest pass reports the specific inconsistency
        layout = None
    if layout is not None:
        try:
            program = lower_exec(layout, manifest.elem_widths())
        except (ValueError, AssertionError) as e:
            report.findings.append(Finding(
                "program/lowering", Severity.ERROR,
                f"manifest layout does not lower: {e}"))
    ctx = AnalysisContext(
        layout=layout, program=program, manifest=manifest,
        streams=None if streams is None else np.asarray(streams),
        stream_digest=stream_digest)
    sub = run_passes(ctx, passes, subject=subject)
    report.findings.extend(sub.findings)
    report.passes = sub.passes
    return report


def verify_kvcache(kvc: Any, *, pages_digest: str | None = None,
                   passes: Iterable[str] | None = None,
                   subject: str = "") -> Report:
    """Verify a :class:`~repro_torch.kvcache.PackedKVCache`: the layout its
    manifest rebinds, the lowered tables, and the mutable-stream facts
    the append path depends on (see the ``kvcache`` pass).

    ``pages_digest``: expected sha256 of the page words (recorded by
    ``CheckpointManager.save_packed(..., kv=...)``); checked when given.
    A manifest that cannot rebind a layout degrades to a finding, and
    the geometry/digest checks still run.
    """
    man = kvc.manifest
    subject = subject or \
        f"PackedKVCache[int{man.bits}/pt{man.page_tokens}]"
    report = Report(subject=subject)
    layout = program = None
    try:
        layout = kvc.layout
        program = kvc.program()
    except (ValueError, AssertionError) as e:
        report.findings.append(Finding(
            "kvcache/rebind", Severity.ERROR,
            f"KV manifest does not rebind a layout: {e}"))
    ctx = AnalysisContext(layout=layout, program=program, kvcache=kvc,
                          stream_digest=pages_digest)
    sub = run_passes(ctx, KVCACHE_PASSES if passes is None else passes,
                     subject=subject)
    report.findings.extend(sub.findings)
    report.passes = sub.passes
    return report


def verify_tree(pt: Any, *, passes: Iterable[str] | None = None) -> Report:
    """Verify a whole :class:`~repro_torch.tree.PackedTree`: its manifest,
    the layout it rebinds, the lowered tables, and the stream buffers'
    byte-lengths, read through one host copy of the streams."""
    man = pt.manifest
    streams = None if pt.streams is None else pt.streams.cpu().numpy()
    return verify_manifest(
        man, streams=streams, passes=passes,
        subject=f"PackedTree[{man.arch}]")
