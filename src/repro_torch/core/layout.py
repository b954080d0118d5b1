"""Layout IR: the output of the Iris scheduler.

Own copy of ``src/repro/core/layout.py``, trimmed to what the serving
path reads: the interval-native :class:`Layout` (count runs, vectorized
legality check, lazy intervals, validation, rebind).  The paper metrics
(``LayoutMetrics``: lateness, FIFO depths), the per-cycle views and the
ASCII renderer stay in the reference.

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
class Interval:
    """A run of ``n_cycles`` cycles sharing one per-cycle segment structure.

    ``slots`` holds (array, bit_offset, elems_per_cycle); element indices for
    cycle ``c`` within the interval are ``elem_base[i] + c * elems_per_cycle``.
    """

    start_cycle: int
    n_cycles: int
    slots: tuple[tuple[int, int, int], ...]   # (array, bit_offset, n_elems)
    elem_base: tuple[int, ...]                # first element idx per slot


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
        # lowered execution programs (repro_torch.core.exec_plan), keyed
        # by piece-width tuple; shared across rebinds (programs are
        # name-free), so a LayoutCache hit never re-lowers
        self._exec_cache: dict[tuple, object] = {}
        self._flat: tuple | None = None
        self._check_intervals_fast()

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
