"""The analyzer passes: static proofs over layouts and lowered tables.

Own copy of ``src/repro/analysis/passes.py`` for the port, over the
port's own :mod:`repro_torch.core` layouts and programs and
:mod:`repro_torch.kvcache` append tables.  One rule differs on purpose:
the ``extraction`` pass emits no ``extraction/host-fallback`` warning.
The reference decodes pieces wider than 32 bits on the host and warns
about it; the port decodes them on the card as two u32 fields, so such
a warning would be false here.  Every other rule, message, locus and
severity is the reference's.

Iris's thesis is that a layout is a *provable* object: every element
occupies a known bit interval in a known bus word, so disjointness,
coverage, alignment and bandwidth efficiency are statically decidable
from the :class:`~repro_torch.core.layout.Layout` /
:class:`~repro_torch.core.exec_plan.ExecProgram` alone — a compiler analysis,
not a runtime check.  Each pass here consumes an
:class:`AnalysisContext` and emits :class:`~repro_torch.analysis.findings.Finding`
objects; nothing executes a kernel or touches a device.

Pass catalog (rule ids are ``"<pass>/<check>"``):

``interval``   — interval safety over the layout IR: per-cycle bus
                 overflow, slot bit-range overlap, slots past the bus
                 edge, element coverage per array.
``program``    — interval safety over the lowered piece tables: exact
                 (integer) proof that all packed bit intervals are
                 pairwise disjoint, in-buffer, and inside the bus row —
                 including the u64-pack vs u32-kernel row-padding seam.
``kernel``     — the fused-decode slot table and gathers: widths, slot
                 offsets, gather index range/uniqueness, and conformance
                 of the table against the piece tables.
``stream``     — stream-direct gather safety: global bit offsets stay
                 in-stream, inside their row, and addressable in u32.
``extraction`` — funnel-shift legality: every element of at most 32
                 bits spans <= 2 u32 words; no piece is wider than 64.
``manifest``   — a PackedTree/checkpoint manifest agrees with itself and
                 with the stream bytes: signature, intervals, shapes,
                 stream byte-lengths, content digest.
``bandwidth``  — the paper's efficiency metric as lint: B_eff, wasted
                 bits, scheduling-unit padding, staging alignment.
``kvcache``    — a PackedKVCache and its append tables: per-token write
                 masks pairwise disjoint and exactly covering the
                 in-range piece bits (padding never written), page
                 geometry/digest vs the KV manifest, and per-page
                 append idempotence (unpack-then-repack reproduces the
                 page bytes exactly).

All arithmetic is exact: positions are int64 bit indices (stream sizes
are < 2^32 bits by construction, enforced by the ``stream`` pass).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable, Iterable

import numpy as np

from ..core.exec_plan import KERNEL_MAX_WIDTH, _TAB_WIDTH_SHIFT, ExecProgram
from ..core.layout import Layout
from ..kvcache.layout import append_tables

from .findings import Finding, Report, Severity

#: default B_eff below which the bandwidth pass escalates to WARNING
DEFAULT_B_EFF_WARN = 0.5

#: per-array padding fraction above which unit padding is a WARNING
DEFAULT_PAD_WARN = 0.05


@dataclasses.dataclass
class AnalysisContext:
    """Everything a pass may consume.  Any field may be ``None``; passes
    that lack their inputs are skipped (recorded in the report)."""

    layout: Layout | None = None
    program: ExecProgram | None = None
    #: a :class:`repro_torch.tree.LayoutManifest` (duck-typed)
    manifest: Any = None
    #: host stream buffers ``(n_layers, c_max, row_bytes)`` uint8
    streams: np.ndarray | None = None
    #: expected sha256 hexdigest of ``streams`` bytes (checkpoint extra)
    stream_digest: str | None = None
    #: a :class:`repro_torch.kvcache.PackedKVCache` (duck-typed, like
    #: manifest)
    kvcache: Any = None
    b_eff_warn: float = DEFAULT_B_EFF_WARN
    pad_warn: float = DEFAULT_PAD_WARN

    def piece_positions(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row, bit_in_row, width) int64 vectors for every piece."""
        prog = self.program
        assert prog is not None
        word = prog.word.astype(np.int64)
        shift = prog.shift.astype(np.int64)
        row, w_in_row = np.divmod(word, prog.wpr)
        bit_in_row = w_in_row * 64 + shift
        widths = np.empty(prog.n_pieces, dtype=np.int64)
        for i, ew in enumerate(prog.elem_widths):
            widths[prog.piece_base[i]:prog.piece_base[i + 1]] = ew
        return row, bit_in_row, widths

    def piece_array_names(self) -> list[str]:
        """Array name owning each piece (defaults to indices)."""
        prog = self.program
        assert prog is not None
        if self.layout is not None:
            names = [a.name for a in self.layout.problem.arrays]
        else:
            names = [f"array{i}" for i in range(len(prog.piece_depths))]
        out: list[str] = []
        for i, name in enumerate(names):
            out.extend([name] * (prog.piece_base[i + 1] - prog.piece_base[i]))
        return out


PassFn = Callable[[AnalysisContext], Iterable[Finding]]

#: registered passes, in run order
PASSES: dict[str, PassFn] = {}


def register_pass(name: str):
    def _add(fn: PassFn) -> PassFn:
        PASSES[name] = fn
        return fn
    return _add


def _err(rule: str, msg: str, *, array: str = "", locus: str = "",
         hint: str = "") -> Finding:
    return Finding(rule, Severity.ERROR, msg, array=array, locus=locus,
                   fixit_hint=hint)


def _warn(rule: str, msg: str, *, array: str = "", locus: str = "",
          hint: str = "") -> Finding:
    return Finding(rule, Severity.WARNING, msg, array=array, locus=locus,
                   fixit_hint=hint)


def _info(rule: str, msg: str, *, array: str = "", locus: str = "",
          hint: str = "") -> Finding:
    return Finding(rule, Severity.INFO, msg, array=array, locus=locus,
                   fixit_hint=hint)


# ----------------------------------------------------------------------
# interval safety over the layout IR
# ----------------------------------------------------------------------
@register_pass("interval")
def interval_pass(ctx: AnalysisContext) -> Iterable[Finding]:
    """Per-cycle legality of the interval-native layout, reimplemented
    independently of :meth:`Layout.validate` (findings, not asserts).

    A vectorized screen decides the common (legal) case in O(slots)
    numpy; only a layout that fails the screen takes the per-run Python
    walk that localizes the findings.  (The reference's persistent
    layout-cache tier runs this pass on every disk load; the port has
    not copied that tier yet.)
    """
    lay = ctx.layout
    if lay is None:
        return
    if not _interval_screen(lay):
        return
    yield from _interval_walk(lay)


def _interval_screen(lay) -> bool:
    """True if the layout *might* be illegal (run the localizing walk).

    Checks the same facts as the walk, in bulk: slot array indices in
    range, per-run bit usage within the bus, per-array scheduled element
    totals equal to depths.  Slot bit ranges are assigned sequentially
    from offset 0, so overlap is equivalent to bus overflow and needs no
    separate screen.
    """
    prob = lay.problem
    n_arrays = len(prob.arrays)
    run_id, arrs, cnts, taus = lay.flat_counts()
    if not arrs.size:
        return any(a.depth for a in prob.arrays)
    if ((arrs < 0) | (arrs >= n_arrays)).any():
        return True
    widths = np.asarray([a.width for a in prob.arrays], dtype=np.int64)
    used = np.zeros(len(lay.count_intervals), dtype=np.int64)
    np.add.at(used, run_id, cnts * widths[arrs])
    if (used > prob.m).any():
        return True
    scheduled = np.zeros(n_arrays, dtype=np.int64)
    np.add.at(scheduled, arrs, cnts * taus[run_id])
    depths = np.asarray([a.depth for a in prob.arrays], dtype=np.int64)
    return bool((scheduled != depths).any())


def _interval_walk(lay) -> Iterable[Finding]:
    prob = lay.problem
    scheduled = [0] * len(prob.arrays)
    t = 0
    for n_cycles, counts in lay.count_intervals:
        used = 0
        ranges: list[tuple[int, int, int]] = []
        off = 0
        for array, n in counts:
            if not (0 <= array < len(prob.arrays)):
                yield _err("interval/unknown-array",
                           f"slot references array index {array} "
                           f"(problem has {len(prob.arrays)})",
                           locus=f"cycle {t}")
                continue
            spec = prob.arrays[array]
            hi = off + n * spec.width
            ranges.append((off, hi, array))
            used += n * spec.width
            scheduled[array] += n * n_cycles
            off = hi
        if used > prob.m:
            yield _err("interval/bus-overflow",
                       f"{used} bits scheduled on a {prob.m}-bit bus",
                       locus=f"cycle {t}",
                       hint="re-run the scheduler; the layout is not a "
                            "legal transfer plan")
        for lo, hi, array in ranges:
            if hi > prob.m:
                yield _err("interval/slot-oob",
                           f"slot [{lo}, {hi}) exceeds the {prob.m}-bit bus",
                           array=prob.arrays[array].name,
                           locus=f"cycle {t}")
        srt = sorted((lo, hi) for lo, hi, _ in ranges)
        for (a0, a1), (b0, _b1) in zip(srt, srt[1:]):
            if b0 < a1:
                yield _err("interval/overlap",
                           f"slot bit ranges overlap at bit {b0}",
                           locus=f"cycle {t}")
        t += n_cycles
    for i, spec in enumerate(prob.arrays):
        if scheduled[i] != spec.depth:
            yield _err("interval/coverage-gap",
                       f"scheduled {scheduled[i]} of {spec.depth} elements",
                       array=spec.name,
                       hint="the layout does not transfer the array "
                            "exactly once")


# ----------------------------------------------------------------------
# interval safety over the lowered piece tables
# ----------------------------------------------------------------------
@register_pass("program")
def program_pass(ctx: AnalysisContext) -> Iterable[Finding]:
    """Exact-arithmetic proof over ``ExecProgram.word``/``shift``: every
    packed bit interval is in-buffer, inside its bus row (the u64-pack vs
    u32-kernel row-padding seam), and pairwise disjoint."""
    prog = ctx.program
    if prog is None:
        return
    if prog.m % 8:
        yield _err("program/bus-alignment",
                   f"bus width {prog.m} is not byte-aligned")
    names = ctx.piece_array_names()
    row, bit_in_row, widths = ctx.piece_positions()
    n_words = prog.c_max * prog.wpr

    word = prog.word.astype(np.int64)
    bad = np.flatnonzero((word < 0) | (word >= n_words))
    for j in bad[:8]:
        yield _err("program/oob-word",
                   f"destination word {int(word[j])} outside the "
                   f"{n_words}-word buffer",
                   array=names[j], locus=f"piece {int(j)}",
                   hint="lowered table is corrupt; re-lower the layout")
    if bad.size > 8:
        yield _err("program/oob-word",
                   f"... and {bad.size - 8} more out-of-buffer pieces")
    ok = np.flatnonzero((word >= 0) & (word < n_words))

    # the row-padding seam: the u64 pack view pads rows to wpr*8 bytes,
    # the u32 kernel view to words32*4 — bits past m in a row are
    # padding in both, so a piece must end at or before bit m of its row
    seam = ok[bit_in_row[ok] + widths[ok] > prog.m]
    for j in seam[:8]:
        yield _err("program/row-seam",
                   f"piece occupies row bits [{int(bit_in_row[j])}, "
                   f"{int(bit_in_row[j] + widths[j])}) past the "
                   f"{prog.m}-bit bus row",
                   array=names[j], locus=f"piece {int(j)}",
                   hint="shift/width corrupt: the piece would read row "
                        "padding or the next row")
    if seam.size > 8:
        yield _err("program/row-seam",
                   f"... and {seam.size - 8} more pieces past the row edge")

    # pairwise disjointness of all piece intervals, in bus-bit space
    starts = row[ok] * np.int64(prog.m) + bit_in_row[ok]
    ends = starts + widths[ok]
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    ov = np.flatnonzero(s[1:] < e[:-1])
    for x in ov[:8]:
        ja, jb = int(ok[order[x]]), int(ok[order[x + 1]])
        yield _err("program/overlap",
                   f"pieces {ja} ({names[ja]}) and {jb} ({names[jb]}) "
                   f"overlap at bus bit {int(s[x + 1])}",
                   array=names[jb], locus=f"piece {jb}",
                   hint="two elements claim the same bits; the layout "
                        "or its lowering is corrupt")
    if ov.size > 8:
        yield _err("program/overlap",
                   f"... and {ov.size - 8} more overlapping piece pairs")

    # coverage: piece granularity must tile each element exactly
    if ctx.layout is not None:
        prob = ctx.layout.problem
        for i, (a, ew) in enumerate(zip(prob.arrays, prog.elem_widths)):
            if ew <= 0 or a.width % ew:
                yield _err("program/granularity",
                           f"piece width {ew} does not divide element "
                           f"width {a.width}", array=a.name)
                continue
            subs = a.width // ew
            if prog.piece_depths[i] != a.depth * subs:
                yield _err("program/coverage-gap",
                           f"{prog.piece_depths[i]} pieces cannot cover "
                           f"{a.depth} elements of {subs} pieces each",
                           array=a.name)


# ----------------------------------------------------------------------
# fused-decode kernel table
# ----------------------------------------------------------------------
@register_pass("kernel")
def kernel_pass(ctx: AnalysisContext) -> Iterable[Finding]:
    """The fused kernel's slot table and gathers: every entry decodes a
    real piece, in range, and the gathers are a permutation."""
    prog = ctx.program
    if prog is None:
        return
    kt = prog.kernel
    names = ctx.piece_array_names()
    kernel_arrays = tuple(i for i, ew in enumerate(prog.elem_widths)
                          if ew <= KERNEL_MAX_WIDTH)
    n_kernel = sum(prog.piece_depths[i] for i in kernel_arrays)
    if not n_kernel:
        return
    rows_nz, cols_nz = np.nonzero(kt.tab)
    if rows_nz.size != n_kernel:
        yield _err("kernel/slot-count",
                   f"slot table has {rows_nz.size} entries for "
                   f"{n_kernel} kernel-eligible pieces",
                   hint="table and piece bookkeeping disagree; re-lower")
    entries = kt.tab[rows_nz, cols_nz].astype(np.int64)
    off = entries & ((1 << _TAB_WIDTH_SHIFT) - 1)
    width = entries >> _TAB_WIDTH_SHIFT
    row_bits = kt.words32 * 32
    for idx in np.flatnonzero(width > KERNEL_MAX_WIDTH)[:8]:
        yield _err("kernel/width",
                   f"slot width {int(width[idx])} > {KERNEL_MAX_WIDTH} "
                   "(u32 funnel shifts decode at most 32-bit pieces)",
                   locus=f"tab[{int(rows_nz[idx])}, {int(cols_nz[idx])}]")
    oob = np.flatnonzero((off + width > prog.m) | (off + width > row_bits))
    for idx in oob[:8]:
        yield _err("kernel/oob",
                   f"slot bits [{int(off[idx])}, "
                   f"{int(off[idx] + width[idx])}) exceed the "
                   f"{prog.m}-bit bus row",
                   locus=f"tab[{int(rows_nz[idx])}, {int(cols_nz[idx])}]",
                   hint="the kernel would gather row padding or OOB words")

    # conformance: the (row, bit, width) multiset must equal the piece
    # tables' kernel-eligible positions
    row, bit_in_row, widths = ctx.piece_positions()
    ids = np.concatenate([
        np.arange(prog.piece_base[i], prog.piece_base[i + 1])
        for i in kernel_arrays]) if kernel_arrays else np.empty(0, np.int64)
    want = np.stack([row[ids], bit_in_row[ids], widths[ids]], axis=1)
    got = np.stack([rows_nz.astype(np.int64), off, width], axis=1)
    if want.shape != got.shape or not np.array_equal(
            want[np.lexsort(want.T[::-1])], got[np.lexsort(got.T[::-1])]):
        yield _err("kernel/table-mismatch",
                   "slot table does not encode the same (row, bit, width) "
                   "set as the piece tables",
                   hint="kernel table skewed against pack tables; "
                        "decode would not invert pack")

    # gathers: in-range, duplicate-free, right cardinality per array
    seen = np.zeros(kt.tab.size, dtype=bool)
    for i, g in kt.gathers:
        depth = prog.piece_base[i + 1] - prog.piece_base[i]
        aname = names[prog.piece_base[i]] if depth else f"array{i}"
        if g.shape[0] != depth:
            yield _err("kernel/gather-count",
                       f"gather has {g.shape[0]} indices for {depth} pieces",
                       array=aname)
        bad = np.flatnonzero((g < 0) | (g >= kt.tab.size))
        if bad.size:
            yield _err("kernel/gather-oob",
                       f"{bad.size} gather indices outside the "
                       f"{kt.tab.size}-slot grid (first: "
                       f"{int(g[bad[0]])})", array=aname)
            continue
        # collisions within this gather AND against other arrays' lanes
        uniq, counts = np.unique(g, return_counts=True)
        n_dup = int((counts - 1).sum()) + int(seen[uniq].sum())
        if n_dup:
            first = uniq[(counts > 1) | seen[uniq]][0]
            yield _err("kernel/gather-dup",
                       f"{n_dup} gather indices collide on a grid slot "
                       f"(first: {int(first)})",
                       array=aname,
                       hint="two elements would decode from one lane")
        seen[g] = True


# ----------------------------------------------------------------------
# stream-direct gather safety
# ----------------------------------------------------------------------
@register_pass("stream")
def stream_pass(ctx: AnalysisContext) -> Iterable[Finding]:
    """Global bit offsets consumed by the stream-direct matmul gather:
    in-stream, addressable in u32, and never crossing a row boundary."""
    prog = ctx.program
    if prog is None:
        return
    names = ctx.piece_array_names()
    row_bits = prog.kernel.words32 * 32
    total_bits = prog.c_max * row_bits
    for i, ew in enumerate(prog.elem_widths):
        if ew > KERNEL_MAX_WIDTH:
            continue  # wider arrays never enter a stream gather
        lo = prog.piece_base[i]
        aname = names[lo] if prog.piece_depths[i] else f"array{i}"
        try:
            gbit = prog.stream_bit_offsets(i).astype(np.int64)
        except ValueError as e:
            yield _err("stream/address-range", str(e), array=aname)
            continue
        oob = np.flatnonzero(gbit + ew > total_bits)
        for j in oob[:8]:
            yield _err("stream/oob",
                       f"gather bits [{int(gbit[j])}, {int(gbit[j]) + ew})"
                       f" exceed the {total_bits}-bit stream",
                       array=aname, locus=f"piece {lo + int(j)}")
        seam = np.flatnonzero((gbit % row_bits) + ew > row_bits)
        for j in seam[:8]:
            yield _err("stream/row-seam",
                       "gather crosses a u32-view row boundary "
                       f"(row bit {int(gbit[j] % row_bits)} + {ew})",
                       array=aname, locus=f"piece {lo + int(j)}")


# ----------------------------------------------------------------------
# extraction legality
# ----------------------------------------------------------------------
@register_pass("extraction")
def extraction_pass(ctx: AnalysisContext) -> Iterable[Finding]:
    """Funnel-shift legality per array: a piece of at most 32 bits must
    span <= 2 u32 words; a wider one (up to 64 bits) travels as two u32
    fields on the card, so it needs no finding (the reference warns
    ``extraction/host-fallback`` here: its host decodes such pieces)."""
    prog = ctx.program
    if prog is None:
        return
    names = ctx.piece_array_names()
    row, bit_in_row, widths = ctx.piece_positions()
    for i, ew in enumerate(prog.elem_widths):
        lo, hi = prog.piece_base[i], prog.piece_base[i + 1]
        aname = names[lo] if hi > lo else f"array{i}"
        if ew > 64:
            yield _err("extraction/width",
                       f"piece width {ew} > 64: not unpackable on any path",
                       array=aname,
                       hint="lower at a finer granularity (elem_widths)")
            continue
        if ew > KERNEL_MAX_WIDTH:
            continue
        # device path: (gbit & 31) + width <= 64 <=> spans <= 2 u32 words
        span = (bit_in_row[lo:hi] & 31) + ew
        bad = np.flatnonzero(span > 64)
        for j in bad[:8]:
            yield _err("extraction/funnel-span",
                       f"element spans {int(span[j])} bits from its u32 "
                       "word base (> 2 words): funnel shift cannot "
                       "extract it",
                       array=aname, locus=f"piece {lo + int(j)}")


# ----------------------------------------------------------------------
# manifest consistency
# ----------------------------------------------------------------------
def stream_sha256(streams: np.ndarray) -> str:
    """Content digest of the packed stream bytes (checkpoint integrity)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(streams).view(np.uint8).tobytes())
    return h.hexdigest()


@register_pass("manifest")
def manifest_pass(ctx: AnalysisContext) -> Iterable[Finding]:
    """A manifest, its layout, and the stream bytes must mutually agree:
    signature, intervals, geometry, per-tensor shapes, byte-lengths and
    (when recorded) the content digest."""
    man = ctx.manifest
    if man is None:
        return
    try:
        prob = man.problem()
    except Exception as e:  # corrupt bundle spec
        yield _err("manifest/bundle",
                   f"bundle spec does not build a problem: {e}")
        return
    if prob.canonical_signature() != man.signature:
        yield _err("manifest/signature",
                   "manifest signature does not match its bundle problem",
                   hint="manifest is corrupt or from an incompatible "
                        "version; do not rebind")
    if man.m % 8 or man.row_bytes != man.m // 8:
        yield _err("manifest/row-bytes",
                   f"row_bytes {man.row_bytes} inconsistent with bus "
                   f"width {man.m}")
    lay = ctx.layout
    if lay is None:
        try:
            lay = Layout.from_count_intervals(prob, man.intervals)
            lay.validate()
        except (ValueError, AssertionError) as e:
            yield _err("manifest/intervals",
                       f"count-intervals do not rebuild a legal layout: {e}",
                       hint="checkpoint corrupt: elements would be "
                            "dropped or duplicated on restore")
            lay = None
    if lay is not None and lay.c_max != man.c_max:
        yield _err("manifest/c-max",
                   f"intervals span {lay.c_max} cycles, manifest says "
                   f"{man.c_max}")
    # per-tensor shapes vs the scheduled capacity
    by_name = {b.name: b for b in man.bundle}
    g = man.spec.group_size
    for key, (kk, nn) in dict(man.shapes).items():
        bname = key.split("/", 1)[1] if "/" in key else key
        w = by_name.get(bname)
        s = by_name.get(f"{bname}_scales")
        if w is None or s is None:
            yield _err("manifest/shapes",
                       f"{key}: bundle lacks tensor {bname!r} or its scales",
                       array=bname)
            continue
        if kk * nn > w.n_elems:
            yield _err("manifest/shapes",
                       f"{key}: shape ({kk}, {nn}) needs {kk * nn} "
                       f"elements, bundle holds {w.n_elems}",
                       array=bname)
        if kk % g:
            yield _err("manifest/shapes",
                       f"{key}: K={kk} not divisible by group_size {g}",
                       array=bname)
        elif (kk // g) * nn > s.n_elems:
            yield _err("manifest/shapes",
                       f"{key}: needs {(kk // g) * nn} scales, bundle "
                       f"holds {s.n_elems}", array=f"{bname}_scales")
    # stream byte-lengths
    if ctx.streams is not None:
        st = np.asarray(ctx.streams)
        want = (man.n_layers, man.c_max, man.row_bytes)
        if st.dtype != np.uint8:
            yield _err("manifest/stream-dtype",
                       f"stream buffer dtype {st.dtype} != uint8")
        if tuple(st.shape) != want:
            yield _err("manifest/stream-shape",
                       f"stream buffer shape {tuple(st.shape)} != "
                       f"{want} (n_layers, c_max, row_bytes)",
                       hint="stream bytes truncated or from a different "
                            "layout; refusing would-be garbage gathers")
        elif ctx.stream_digest is not None:
            got = stream_sha256(st)
            if got != ctx.stream_digest:
                yield _err("manifest/stream-digest",
                           f"stream content digest {got[:16]}... does not "
                           f"match recorded {ctx.stream_digest[:16]}...",
                           hint="stream words were corrupted in storage "
                                "or transit")


# ----------------------------------------------------------------------
# bandwidth audit
# ----------------------------------------------------------------------
@register_pass("bandwidth")
def bandwidth_pass(ctx: AnalysisContext) -> Iterable[Finding]:
    """The paper's efficiency metric (Eq. 1) as lint: wasted bus bits,
    per-tensor scheduling-unit padding, and staging alignment."""
    lay = ctx.layout
    if lay is None:
        return
    prob = lay.problem
    c_max = lay.c_max
    total = c_max * prob.m
    b_eff = prob.p_tot / total if total else 0.0
    wasted = total - prob.p_tot
    mk = _warn if b_eff < ctx.b_eff_warn else _info
    yield mk("bandwidth/efficiency",
             f"B_eff = {b_eff:.4f} ({wasted} of {total} bus bits idle "
             f"over {c_max} cycles)",
             hint="" if b_eff >= ctx.b_eff_warn else
             "layout wastes more than "
             f"{(1 - ctx.b_eff_warn) * 100:.0f}% of bus bandwidth; "
             "check lane caps / due dates or try another strategy")
    prog = ctx.program
    if prog is not None:
        # staging alignment: bits per row added by the u32 kernel view
        pad = prog.kernel.words32 * 32 - prob.m
        if pad:
            yield _info("bandwidth/row-alignment",
                        f"u32 staging pads each row by {pad} bits "
                        f"({prob.m} -> {prog.kernel.words32 * 32})",
                        hint="host-staging only; DMA moves row_bytes")
        # scheduling-unit padding per tensor (manifest knows true counts)
        if ctx.manifest is not None:
            by_name = {b.name: b for b in ctx.manifest.bundle}
            for i, a in enumerate(prob.arrays):
                b = by_name.get(a.name)
                if b is None:
                    continue
                cap_bits = prog.piece_depths[i] * prog.elem_widths[i]
                used_bits = b.n_elems * b.width_bits
                pad_bits = cap_bits - used_bits
                if pad_bits < 0:
                    yield _err("bandwidth/unit-padding",
                               f"{b.n_elems} elements exceed the "
                               f"scheduled capacity "
                               f"{prog.piece_depths[i]} pieces",
                               array=a.name)
                elif pad_bits:
                    frac = pad_bits / cap_bits
                    mk2 = _warn if frac > ctx.pad_warn else _info
                    yield mk2("bandwidth/unit-padding",
                              f"{pad_bits} pad bits "
                              f"({frac * 100:.2f}% of the tensor's "
                              "stream share) from unit rounding",
                              array=a.name,
                              hint="" if frac <= ctx.pad_warn else
                              "shrink the scheduling unit (lanes_target) "
                              "or repack the tensor")


# ----------------------------------------------------------------------
# packed KV-cache: mutable-stream safety
# ----------------------------------------------------------------------
def _popcount32(x: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint32 array (SWAR, wrap-on-overflow)."""
    x = x.astype(np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2))
                                       & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def _expected_write_mask(ctx: AnalysisContext, logical) -> np.ndarray:
    """(c_max, words32) u32 bits every *in-range* piece occupies, derived
    from the piece tables directly (independent of the append tables'
    pack-table inversion)."""
    prog = ctx.program
    row, bit_in_row, widths = ctx.piece_positions()
    n_arr = len(prog.piece_depths)
    base = np.asarray(prog.piece_base, dtype=np.int64)
    arr_id = np.repeat(np.arange(n_arr), np.diff(base))
    local = np.arange(prog.n_pieces) - base[arr_id]
    in_range = local < np.asarray(logical, dtype=np.int64)[arr_id]
    w32 = prog.kernel.words32
    r, b, w = row[in_range], bit_in_row[in_range], widths[in_range]
    q, sh = np.divmod(b, 32)
    m64 = ((np.uint64(1) << w.astype(np.uint64)) - np.uint64(1)) \
        << sh.astype(np.uint64)
    exp = np.zeros((prog.c_max, w32), np.uint64)
    np.bitwise_or.at(exp, (r, q), m64 & np.uint64(0xFFFFFFFF))
    hi = m64 >> np.uint64(32)
    has_hi = (hi != 0) & (q + 1 < w32)   # row-seam pieces already flagged
    np.bitwise_or.at(exp, (r[has_hi], q[has_hi] + 1), hi[has_hi])
    return exp.astype(np.uint32)


@register_pass("kvcache")
def kvcache_pass(ctx: AnalysisContext) -> Iterable[Finding]:
    """Mutable-stream safety for a packed KV-cache: the masked-RMW append
    path is only sound if (a) per-token write masks are pairwise
    disjoint, (b) their union is exactly the in-range piece bits (so
    padding is never written and every payload bit has exactly one
    owner), and (c) a page's bytes are a fixed point of
    unpack-then-repack (appends compose with the static pack tables).
    Geometry and content digest are checked against the KV manifest."""
    kvc = ctx.kvcache
    if kvc is None:
        return
    man = kvc.manifest
    try:
        prob = man.problem()
    except Exception as e:  # corrupt bundle spec
        yield _err("kvcache/bundle",
                   f"KV bundle spec does not build a problem: {e}")
        return
    # KV signatures are stored JSON-canonical (strings survive the
    # checkpoint-extra round trip; tuples would come back as lists)
    if json.dumps(prob.canonical_signature()) != man.signature:
        yield _err("kvcache/signature",
                   "KV manifest signature does not match its bundle "
                   "problem",
                   hint="manifest is corrupt or from an incompatible "
                        "version; do not rebind")
    pages = np.asarray(kvc.host_pages())
    want = (man.n_layers, man.n_slots, man.n_pages, man.c_max, man.words32)
    if pages.dtype != np.uint32 or tuple(pages.shape) != want:
        yield _err("kvcache/pages-shape",
                   f"page buffer {pages.dtype}{tuple(pages.shape)} != "
                   f"uint32{want} (n_layers, n_slots, n_pages, c_max, "
                   "words32)",
                   hint="pages truncated or from a different KV layout")
        return
    if ctx.stream_digest is not None:
        got = stream_sha256(pages)
        if got != ctx.stream_digest:
            yield _err("kvcache/pages-digest",
                       f"KV page content digest {got[:16]}... does not "
                       f"match recorded {ctx.stream_digest[:16]}...",
                       hint="page words were corrupted in storage or "
                            "transit")
    prog = ctx.program
    if prog is None:
        return

    try:
        tabs = append_tables(prog, page_tokens=man.page_tokens,
                             logical=man.logical())
    except (ValueError, AssertionError) as e:
        yield _err("kvcache/append-tables",
                   f"append tables do not derive from the program: {e}")
        return
    mk = tabs.maskbits                       # (c_max, words32, K) u32
    union = np.zeros(mk.shape[:2], np.uint32)
    popsum = np.zeros(mk.shape[:2], np.int64)
    for kk in range(tabs.K):
        union |= mk[:, :, kk]
        popsum += _popcount32(mk[:, :, kk])
    clash = popsum != _popcount32(union)
    if clash.any():
        r, q = np.argwhere(clash)[0]
        yield _err("kvcache/mask-overlap",
                   f"{int(clash.sum())} destination words have "
                   "overlapping token write masks (first: row "
                   f"{int(r)}, word {int(q)})",
                   hint="two appends would clobber each other's bits; "
                        "the RMW append path is unsound")
    pad_write = (tabs.tok < 0) & (mk != 0)
    if pad_write.any():
        yield _err("kvcache/padding-write",
                   f"{int(pad_write.sum())} contributions write bits "
                   "owned by residual padding (token id -1)",
                   hint="appends would dirty pad bits, breaking the "
                        "zero-page idempotence invariant")
    exp = _expected_write_mask(ctx, man.logical())
    if (union != exp).any():
        bad = union != exp
        r, q = np.argwhere(bad)[0]
        yield _err("kvcache/mask-coverage",
                   f"token mask union differs from the in-range piece "
                   f"bits in {int(bad.sum())} words (first: row "
                   f"{int(r)}, word {int(q)})",
                   hint="append tables and piece tables disagree on "
                        "which bits are payload")

    # pages start zeroed and appends are masked, so every bit outside
    # the in-range payload mask must still be zero — this catches writes
    # into residual-fill pieces and bus slack alike, which the pack
    # tables would happily reproduce (so idempotence alone cannot)
    stray = pages & ~exp
    if stray.any():
        n_bad = int(_popcount32(stray).sum())
        first = tuple(int(x) for x in np.argwhere(stray)[0])
        yield _err("kvcache/stray-bits",
                   f"{n_bad} page bits set outside the in-range payload "
                   f"mask (first word: {first})",
                   hint="an append escaped its token mask or the pages "
                        "were corrupted; reads would see garbage after "
                        "the next overwrite")

    # append idempotence over sampled pages: unpack -> repack must be a
    # byte fixed point (pages start zeroed and appends are masked, so
    # every non-payload bit is 0 and pack_indexed reproduces the page)
    nl, ns, npg = pages.shape[:3]
    coords = [(layer, s, p) for layer in range(nl) for s in range(ns)
              for p in range(npg)]
    coords.sort(key=lambda t: not pages[t].any())   # nonzero pages first
    n_elem = len(prog.elem_widths)
    for t in coords[:6]:
        u8 = np.ascontiguousarray(pages[t]).view(np.uint8) \
            .reshape(man.c_max, man.words32 * 4)
        tail = u8[:, man.row_bytes:]
        if tail.any():
            yield _err("kvcache/row-padding",
                       f"page {t}: u32-view row padding bytes are "
                       "nonzero",
                       hint="writes escaped the bus row; the pack view "
                            "and the DMA view disagree")
            continue
        buf = np.ascontiguousarray(u8[:, :man.row_bytes])
        flat = prog.buffer_words64(buf)
        streams = [prog.unpack_array(flat, i) for i in range(n_elem)]
        back = prog.pack_indexed(streams)
        if not np.array_equal(np.asarray(back, np.uint8), buf):
            yield _err("kvcache/idempotence",
                       f"page {t}: pack(unpack(page)) differs from the "
                       "page bytes",
                       hint="append left bits the static pack tables "
                            "cannot reproduce; the page is corrupt")


# ----------------------------------------------------------------------
# running the passes
# ----------------------------------------------------------------------
def run_passes(ctx: AnalysisContext,
               passes: Iterable[str] | None = None, *,
               subject: str = "") -> Report:
    """Run ``passes`` (default: all registered) over ``ctx``.

    Unknown pass names raise ``KeyError``; passes whose inputs are absent
    from the context simply contribute no findings.
    """
    names = list(PASSES) if passes is None else list(passes)
    report = Report(subject=subject)
    for name in names:
        try:
            fn = PASSES[name]
        except KeyError:
            known = ", ".join(PASSES)
            raise KeyError(
                f"unknown analysis pass {name!r}; registered: {known}"
            ) from None
        report.findings.extend(fn(ctx))
        report.passes.append(name)
    return report
