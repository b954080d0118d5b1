"""Layout IR: the output of the Iris scheduler.

Own copy of ``src/repro/core/layout.py``: the interval-native
:class:`Layout` (count runs, vectorized legality check, lazy intervals,
validation, rebind), the per-cycle :class:`Segment` views of small
layouts (``cycles``, ``element_positions``), the paper metrics
(:class:`LayoutMetrics`: B_eff, lateness, FIFO depths, write ports) and
the ASCII renderer.

A :class:`Layout` assigns every element of every array to a (cycle, bit
offset) position on the bus, in due-date space.  The ground truth is a
list of ``(n_cycles, counts)`` runs where ``counts`` is the constant
per-cycle slot structure ``(array, elems_per_cycle)`` in lane order.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .task import LayoutProblem

# A per-cycle slot structure: ((array_index, elems_per_cycle), ...) lane order.
Counts = tuple[tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class Segment:
    """``n_elems`` consecutive elements of one array in one bus cycle."""

    array: int       # index into problem.arrays
    elem_start: int  # index of the first element transferred
    n_elems: int
    bit_offset: int  # offset of the first element's LSB within the bus word

    def bits(self, problem: LayoutProblem) -> int:
        return self.n_elems * problem.arrays[self.array].width


@dataclasses.dataclass(frozen=True)
class Interval:
    """A run of ``n_cycles`` cycles sharing one per-cycle segment structure.

    ``slots`` holds (array, bit_offset, elems_per_cycle); element indices for
    cycle ``c`` within the interval are ``elem_base[i] + c * elems_per_cycle``.
    """

    start_cycle: int
    n_cycles: int
    slots: tuple[tuple[int, int, int], ...]   # (array, bit_offset, n_elems)
    elem_base: tuple[int, ...]                # first element idx per slot


@dataclasses.dataclass
class LayoutMetrics:
    """Paper metrics: Eq. 1 efficiency, lateness, FIFO depths."""

    c_max: int
    efficiency: float                  # B_eff = p_tot / (C_max * m)
    lateness: dict[str, int]           # L_j per array
    l_max: int
    completion: dict[str, int]         # C_j per array (1-based cycle count)
    fifo_depth: dict[str, int]         # decode-module buffering per array
    wasted_bits: int                   # C_max*m - p_tot

    def row(self) -> dict[str, object]:
        return {
            "C_max": self.c_max,
            "B_eff": round(self.efficiency, 4),
            "L_max": self.l_max,
            "FIFO": dict(self.fifo_depth),
            "wasted_bits": self.wasted_bits,
        }


_MATERIALIZE_LIMIT = 1 << 18  # refuse to expand >256k cycles unless forced


class Layout:
    """A complete bus layout in due-date space, interval-native."""

    def __init__(self, problem: LayoutProblem,
                 count_intervals: Sequence[tuple[int, Counts]], *,
                 _normalized: bool = False) -> None:
        """``count_intervals`` are (n_cycles, counts) runs in final cycle
        order.  ``_normalized=True`` asserts the runs are already
        canonical int tuples (scheduler and cache paths only)."""
        self.problem = problem
        if _normalized:
            self.count_intervals = tuple(count_intervals)
        else:
            self.count_intervals = tuple(
                (int(n), tuple((int(a), int(e)) for a, e in counts if e > 0))
                for n, counts in count_intervals
                if n > 0
            )
        self._intervals: list[Interval] | None = None
        self._cycles: list[list[Segment]] | None = None
        # lowered execution programs (repro_torch.core.exec_plan), keyed
        # by piece-width tuple; shared across rebinds (programs are
        # name-free), so a LayoutCache hit never re-lowers
        self._exec_cache: dict[tuple, object] = {}
        # vectorized replay tables for warm-started re-planning
        # (repro_torch.core.iris._schedule_warm); name-free, so rebinds
        # share them too
        self._replay_cache: dict[str, object] = {}
        self._flat: tuple | None = None
        self._check_intervals_fast()

    @staticmethod
    def from_counts(problem: LayoutProblem,
                    count_cycles: Sequence[Counts],
                    reverse: bool = False) -> "Layout":
        """Build from per-cycle (array, n_elems) counts, merging runs;
        ``reverse=True`` flips the cycle order first (release-time space
        -> due-date space)."""
        seq = list(reversed(count_cycles)) if reverse else list(count_cycles)
        runs: list[tuple[int, Counts]] = []
        for counts in seq:
            counts = tuple((a, e) for a, e in counts if e > 0)
            if runs and runs[-1][1] == counts:
                runs[-1] = (runs[-1][0] + 1, counts)
            else:
                runs.append((1, counts))
        return Layout(problem, runs)

    @staticmethod
    def from_count_intervals(problem: LayoutProblem,
                             intervals: Sequence[tuple[int, Counts]],
                             reverse: bool = False, *,
                             _normalized: bool = False) -> "Layout":
        seq = list(reversed(intervals)) if reverse else list(intervals)
        return Layout(problem, seq, _normalized=_normalized)

    def rebind(self, problem: LayoutProblem) -> "Layout":
        """Re-attach this layout to ``problem`` (same
        ``canonical_signature``) without re-scheduling."""
        if problem == self.problem:
            return self
        if problem.canonical_signature() != self.problem.canonical_signature():
            raise ValueError(
                "rebind target is a different scheduling instance"
            )
        lay = Layout(problem, self.count_intervals, _normalized=True)
        lay._exec_cache = self._exec_cache
        lay._replay_cache = self._replay_cache
        lay._intervals = self._intervals
        lay._flat = self._flat
        return lay

    def flat_counts(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """``(run_id, array_id, count, taus)`` int64 views of the count
        runs, one entry per (run, slot).  Memoized."""
        if self._flat is None:
            run_id: list[int] = []
            arrs: list[int] = []
            cnts: list[int] = []
            for r, (_n, counts) in enumerate(self.count_intervals):
                for a, e in counts:
                    run_id.append(r)
                    arrs.append(a)
                    cnts.append(e)
            self._flat = (
                np.asarray(run_id, dtype=np.int64),
                np.asarray(arrs, dtype=np.int64),
                np.asarray(cnts, dtype=np.int64),
                np.asarray([n for n, _c in self.count_intervals],
                           dtype=np.int64),
            )
        return self._flat

    def _check_intervals_fast(self) -> None:
        """Vectorized legality proof: every run fits the bus and every
        array is scheduled to exactly its depth."""
        prob = self.problem
        run_np, arr_np, cnt_np, taus = self.flat_counts()
        n_arrays = len(prob.arrays)
        depths = np.asarray([a.depth for a in prob.arrays], dtype=np.int64)
        if not arr_np.size:
            bad = int(np.argmax(depths != 0)) if (depths != 0).any() else -1
            if bad >= 0:
                raise ValueError(
                    f"array {prob.arrays[bad].name}: scheduled 0 of "
                    f"{prob.arrays[bad].depth} elements"
                )
            return
        if ((arr_np >= n_arrays) | (arr_np < -n_arrays)).any():
            raise IndexError("array index out of range")
        widths = np.asarray([a.width for a in prob.arrays], dtype=np.int64)
        used = np.zeros(len(self.count_intervals), dtype=np.int64)
        np.add.at(used, run_np, cnt_np * widths[arr_np])
        if (used > prob.m).any():
            r = int(np.argmax(used > prob.m))
            t = sum(n for n, _c in self.count_intervals[:r])
            raise ValueError(
                f"interval at cycle {t} overflows the bus: "
                f"{int(used[r])} > {prob.m} bits"
            )
        scheduled = np.zeros(n_arrays, dtype=np.int64)
        np.add.at(scheduled, arr_np, cnt_np * taus[run_np])
        if (scheduled != depths).any():
            i = int(np.argmax(scheduled != depths))
            raise ValueError(
                f"array {prob.arrays[i].name}: scheduled {int(scheduled[i])} "
                f"of {prob.arrays[i].depth} elements"
            )

    def _build_intervals(self) -> None:
        prob = self.problem
        next_elem = [0] * len(prob.arrays)
        out: list[Interval] = []
        t = 0
        for n_cycles, counts in self.count_intervals:
            offset = 0
            slots: list[tuple[int, int, int]] = []
            base: list[int] = []
            for array, n in counts:
                spec = prob.arrays[array]
                slots.append((array, offset, n))
                base.append(next_elem[array])
                next_elem[array] += n * n_cycles
                offset += n * spec.width
            out.append(Interval(t, n_cycles, tuple(slots), tuple(base)))
            t += n_cycles
        self._intervals = out

    def validate(self) -> None:
        """Check the layout is a legal, complete transfer plan."""
        prob = self.problem
        ranges: list[list[tuple[int, int]]] = [[] for _ in prob.arrays]
        for iv in self.intervals():
            used = 0
            bit_ranges: list[tuple[int, int]] = []
            for (array, off, n), base in zip(iv.slots, iv.elem_base):
                spec = prob.arrays[array]
                if n <= 0:
                    raise AssertionError("empty slot in interval")
                hi = off + n * spec.width
                if hi > prob.m:
                    raise AssertionError(
                        f"cycle {iv.start_cycle}: slot exceeds bus width"
                    )
                bit_ranges.append((off, hi))
                used += n * spec.width
                ranges[array].append((base, base + n * iv.n_cycles))
            if used > prob.m:
                raise AssertionError(
                    f"cycle {iv.start_cycle}: {used} bits > bus {prob.m}"
                )
            bit_ranges.sort()
            for (_a0, a1), (b0, _b1) in zip(bit_ranges, bit_ranges[1:]):
                if b0 < a1:
                    raise AssertionError(
                        f"cycle {iv.start_cycle}: overlapping bit ranges"
                    )
        for i, spec in enumerate(prob.arrays):
            pos = 0
            for lo, hi in sorted(ranges[i]):
                if lo != pos:
                    raise AssertionError(
                        f"array {spec.name}: elements "
                        f"[{min(lo, pos)},{max(lo, pos)}) duplicated or missing"
                    )
                pos = hi
            if pos != spec.depth:
                raise AssertionError(
                    f"array {spec.name}: {spec.depth - pos} elements "
                    "never transferred"
                )

    @property
    def c_max(self) -> int:
        return sum(n for n, _ in self.count_intervals)

    def intervals(self) -> list[Interval]:
        if self._intervals is None:
            self._build_intervals()
        assert self._intervals is not None
        return self._intervals

    @property
    def cycles(self) -> list[list[Segment]]:
        """Per-cycle segment lists (materialized; small layouts only)."""
        if self._cycles is None:
            if self.c_max > _MATERIALIZE_LIMIT:
                raise RuntimeError(
                    f"refusing to materialize {self.c_max} cycles; "
                    "use intervals() instead"
                )
            out: list[list[Segment]] = []
            for iv in self.intervals():
                for c in range(iv.n_cycles):
                    out.append([
                        Segment(array, base + c * n, n, off)
                        for (array, off, n), base in zip(iv.slots,
                                                         iv.elem_base)
                    ])
            self._cycles = out
        return self._cycles

    def element_positions(self, array: int) -> list[tuple[int, int]]:
        """(cycle, bit_offset) per element, in element order."""
        spec = self.problem.arrays[array]
        pos: list[tuple[int, int] | None] = [None] * spec.depth
        for iv in self.intervals():
            for (arr, off, n), base in zip(iv.slots, iv.elem_base):
                if arr != array:
                    continue
                for c in range(iv.n_cycles):
                    for k in range(n):
                        pos[base + c * n + k] = (
                            iv.start_cycle + c,
                            off + k * spec.width,
                        )
        assert all(p is not None for p in pos)
        return pos  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # metrics (paper §4, §6), O(intervals)
    # ------------------------------------------------------------------
    def metrics(self) -> LayoutMetrics:
        prob = self.problem
        last = [0] * len(prob.arrays)
        for iv in self.intervals():
            for (array, _off, _n) in iv.slots:
                last[array] = max(last[array], iv.start_cycle + iv.n_cycles)
        completion = {a.name: last[i] for i, a in enumerate(prob.arrays)}
        lateness = {a.name: last[i] - a.due for i, a in enumerate(prob.arrays)}
        fifo = {a.name: d for a, d in zip(prob.arrays, self.fifo_depths())}
        c_max = self.c_max
        return LayoutMetrics(
            c_max=c_max,
            efficiency=prob.p_tot / (c_max * prob.m),
            lateness=lateness,
            l_max=max(lateness.values()),
            completion=completion,
            fifo_depth=fifo,
            wasted_bits=c_max * prob.m - prob.p_tot,
        )

    def fifo_depths(self) -> list[int]:
        """Decode-side buffering per array (paper §5 running sum): the
        read module forwards one element per array per cycle, so the
        surplus ``e_c - 1`` elements of a cycle are staged."""
        n = len(self.problem.arrays)
        backlog = [0] * n
        depth = [0] * n
        for iv in self.intervals():
            arrived = [0] * n
            for (array, _off, cnt) in iv.slots:
                arrived[array] += cnt
            for i in range(n):
                e = arrived[i]
                tau = iv.n_cycles
                if e == 0:
                    backlog[i] = max(0, backlog[i] - tau)
                elif e > 1:
                    backlog[i] += (e - 1) * tau
                    depth[i] = max(depth[i], backlog[i])
        return depth

    def max_concurrent_elems(self) -> list[int]:
        """Max elements of each array in any single cycle (write ports)."""
        n = len(self.problem.arrays)
        peak = [0] * n
        for iv in self.intervals():
            arrived = [0] * n
            for (array, _off, cnt) in iv.slots:
                arrived[array] += cnt
            for i in range(n):
                peak[i] = max(peak[i], arrived[i])
        return peak

    def render(self, max_cycles: int = 64) -> str:
        """ASCII rendering in the style of the paper's Figs. 3-5."""
        prob = self.problem
        lines = []
        shown = 0
        for iv in self.intervals():
            for c in range(iv.n_cycles):
                if shown >= max_cycles:
                    lines.append(f"  ... ({self.c_max - shown} more cycles)")
                    return "\n".join(lines)
                row = ["."] * prob.m
                for (array, off, n), _base in zip(iv.slots, iv.elem_base):
                    spec = prob.arrays[array]
                    for k in range(n):
                        lo = off + k * spec.width
                        for b in range(spec.width):
                            row[lo + b] = spec.name[0]
                lines.append(f"{iv.start_cycle + c:4d} |{''.join(row)}|")
                shown += 1
        return "\n".join(lines)
