"""Iris layout scheduler (paper Algorithms 1.1, 1.2, 1.3).

Own copy of ``src/repro/core/iris.py`` for the port, whole: the
event-driven interval engine, warm-started re-planning, :func:`schedule`,
the :class:`LayoutCache` with its on-disk tier (entry files byte-equal to
the reference's, so either package loads the other's) and the batch API
:func:`schedule_many`.  It is host code (numpy only): a pool worker
imports nothing but this package's ``core``.

The bus-layout problem is solved as preemptive multiprocessor scheduling
of linear-speedup tasks (Drozdowski 1996): the m-bit bus is m identical
processors, array j is a task with processing time ``p_j = W_j * D_j``,
maximum parallelism ``delta_j = floor(m/W_j)*W_j``, and release time
``r_j = d_max - d_j``.  The schedule is computed forward in release-time
space and reversed into due-date space to optimize ``L_max``.  The
``interval`` and ``cycle`` modes emit bit-identical layouts.

Repeated identical problems are served by :class:`LayoutCache`, a
content-addressed LRU keyed on ``LayoutProblem.canonical_signature()``
with an optional persistent on-disk tier (``cache_dir``, or the
``REPRO_CACHE_DIR`` environment variable for the process-wide default);
:func:`schedule_many` batches and dedupes whole problem lists through it,
fanning unique instances over a process pool when one is available.
Near-miss problems (one array added, removed or re-specified against a
cached neighbour) are warm-started from the neighbour's engine state
(``_schedule_warm``), bit-identical to a cold run by construction.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import warnings
from collections import OrderedDict
from typing import Sequence

import numpy as np

from .layout import Counts, Layout
from .task import LayoutProblem


@dataclasses.dataclass
class _Task:
    idx: int          # index into problem.arrays
    width: int
    release: int
    delta: int        # max bits/cycle (already max_lanes-clamped)
    rem: int          # remaining elements

    @property
    def delta_eff(self) -> int:
        """Usable width right now: never claim lanes beyond remaining work."""
        return min(self.delta, self.rem * self.width)

    @property
    def lanes_eff(self) -> int:
        return self.delta_eff // self.width

    @property
    def height(self) -> int:
        """h(j) = ceil(rem / lanes) — remaining cycles at max parallelism."""
        return -(-self.rem // self.lanes_eff)


def _lrm_allocation(group: list[_Task], avail: int) -> dict[int, int]:
    """Largest-remainder (Hamilton) apportionment in element-width seats.

    Paper Alg 1.3, with the §4 modification: allocations are whole
    multiples of each element's bitwidth (elements are indivisible).
    Returns {task_idx: beta_bits}; beta is a multiple of W and <= delta_eff.
    """
    total = sum(t.delta_eff for t in group)
    assert total > avail > 0
    beta: dict[int, int] = {}
    rem_frac: list[tuple[float, int, _Task]] = []
    for order, t in enumerate(group):
        v = t.delta_eff * avail / total          # fair fractional share
        b = min((int(v) // t.width) * t.width, t.delta_eff)
        beta[t.idx] = b
        rem_frac.append((v - b, order, t))
    spent = sum(beta.values())
    left = avail - spent
    # hand out remaining seats (one element = W_j bits) by largest remainder
    rem_frac.sort(key=lambda x: (-x[0], x[1]))
    progressed = True
    while left > 0 and progressed:
        progressed = False
        for _, _, t in rem_frac:
            if left >= t.width and beta[t.idx] + t.width <= t.delta_eff:
                beta[t.idx] += t.width
                left -= t.width
                progressed = True
                if left == 0:
                    break
    return beta


def _find_capabilities(ready: list[_Task], m: int,
                       fill_residual: bool) -> list[tuple[_Task, int]]:
    """Paper Alg 1.2: allocate bus bits to the highest tasks first.

    Returns [(task, beta_bits)] in allocation (lane) order, beta > 0.
    ``fill_residual=False`` is the paper-faithful behaviour (avail := 0
    after an LRM round, line 27); ``True`` keeps offering leftover bits to
    lower groups — a beyond-paper refinement measured in EXPERIMENTS.md
    §fill_residual.
    """
    avail = m
    out: list[tuple[_Task, int]] = []
    # group by equal height, tallest first; stable within a group
    # (delta_eff is precomputed per task — this is the hot loop)
    by_height: dict[int, list[tuple[_Task, int]]] = {}
    for t in ready:
        de = t.delta
        rw = t.rem * t.width
        if rw < de:
            de = rw
        h = -(-t.rem // (de // t.width))
        by_height.setdefault(h, []).append((t, de))
    for h in sorted(by_height, reverse=True):
        if avail <= 0:
            break
        group = by_height[h]
        total = sum(de for _, de in group)
        if total <= avail:
            for t, de in group:
                out.append((t, de))
            avail -= total
        else:
            beta = _lrm_allocation([t for t, _ in group], avail)
            spent = 0
            for t, _ in group:
                b = beta.get(t.idx, 0)
                if b > 0:
                    out.append((t, b))
                    spent += b
            avail -= spent
            if not fill_residual:
                break          # paper line 27: avail := 0
    return out


# ----------------------------------------------------------------------
# exact event horizon
# ----------------------------------------------------------------------
# FIND_CAPABILITIES is a pure function of, per ready task, the pair
# (height, delta_eff) — heights only through the ordered partition of
# tasks into equal-height groups — plus the stable ready order, which the
# engine never perturbs between events.  A jump of tau cycles replays the
# same allocation bit-exactly iff all of these are invariant for
# k = 0..tau-1.  ``_exact_tau`` returns the largest tau it can *prove*
# safe; any conservatism costs events, never correctness.

_PAIR_EVENT_CAP = 64      # height-drop events examined per task pair
_FAR = 1 << 62


def _next_drop(rem: int, n: int, le: int, h_cur: int, after: int) -> int:
    """Smallest k > after with h(k) < h_cur.

    Heights drop by at most one per cycle (n <= le), so h at that k is
    exactly h_cur - 1.
    """
    return max(after + 1, -(-(rem - le * (h_cur - 1)) // n))


def _pair_bound(ra: int, la: int, ha: int, na: int,
                rb: int, lb: int, hb: int, nb: int, cap: int) -> int:
    """Largest tau <= cap keeping the height relation of the pair fixed.

    Arguments are (rem, lanes_eff, height, alloc_lanes) per task.  The
    relation (>, =, <) of the two integral heights determines whether
    the pair shares a FIND_CAPABILITIES group and in which order the
    groups rank; any change is a height-equalization (or separation)
    event that ends the jump.  Never exceeds the true first-change time;
    the event walk is capped, falling back to the last verified event.
    """
    if na == la and nb == lb:
        # both full-rate: h(k) = h(0) - k exactly for each, so the
        # difference — and the relation — is constant for any k
        return cap
    if nb == 0:
        if ha < hb:
            return cap                   # gap below a static task only grows
        if ha == hb:
            return min(cap, _next_drop(ra, na, la, ha, 0))
        # ha > hb: first k with h_a(k) <= hb
        return min(cap, -(-(ra - la * hb) // na))
    if na == 0:
        if hb < ha:
            return cap
        if hb == ha:
            return min(cap, _next_drop(rb, nb, lb, hb, 0))
        return min(cap, -(-(rb - lb * ha) // nb))
    # both moving at different normalized rates: walk the merged
    # height-drop events (the only cycles where the relation can change);
    # the drop/height arithmetic is inlined — this loop is the engine's
    # hottest path on LRM-contended problems
    rel0 = (ha > hb) - (ha < hb)
    k = 0
    for _ in range(_PAIR_EVENT_CAP):
        ka = -(-(ra - la * (ha - 1)) // na)
        kb = -(-(rb - lb * (hb - 1)) // nb)
        nxt = ka if ka < kb else kb
        k = nxt if nxt > k else k + 1
        if k >= cap:
            return cap
        ha = -(-(ra - k * na) // la)
        hb = -(-(rb - k * nb) // lb)
        rel = (ha > hb) - (ha < hb)
        if rel != rel0:
            return k                     # invariant on [0, k)
    return min(cap, k + 1)               # verified through event k


def _exact_tau(ready: list[_Task], alloc: list[tuple[_Task, int]],
               next_release: int | None, t_now: int) -> int:
    """Event horizon: largest jump with a provably constant allocation.

    Bounds, in order:

    * next release (heap head) — the ready set grows there;
    * element-indivisibility / completion: a task whose remaining
      elements have fallen below its lane count has ``delta_eff = rem*W``
      shrinking every cycle, so the engine steps it per-cycle (this tail
      correction is what makes interval mode bit-identical to cycle
      mode); in the bulk regime ``delta_eff`` is constant until rem
      crosses the lane count;
    * height-equalization: pairwise first time any two ready tasks'
      integral heights merge, split or cross (``_pair_bound``).

    """
    lanes = {task.idx: beta // task.width for task, beta in alloc}
    cap = _FAR if next_release is None else next_release - t_now
    for task, beta in alloc:
        dl = task.delta // task.width
        if task.rem < dl:
            return 1                     # indivisibility tail: exact replay
        cap = min(cap, (task.rem - dl) // lanes[task.idx] + 1)
        if cap <= 1:
            return 1
    # (rem, lanes_eff, height, alloc_lanes) per ready task, computed once
    state = []
    for t in ready:
        le = t.lanes_eff
        state.append((t.rem, le, -(-t.rem // le), lanes.get(t.idx, 0)))
    for i, (ra, la, ha, na) in enumerate(state):
        for (rb, lb, hb, nb) in state[i + 1:]:
            if na == 0 and nb == 0:
                continue                 # both static: nothing moves
            cap = _pair_bound(ra, la, ha, na, rb, lb, hb, nb, cap)
            if cap <= 1:
                return 1
    return cap


# ----------------------------------------------------------------------
# periodic steady-state fast-forward
# ----------------------------------------------------------------------
# While every ready task is in the bulk regime, the per-cycle allocation
# is a pure function of a *relative* fingerprint: ready order, height
# differences, and each task's phase within its current height level
# (rem - lanes*(height-1)).  When the fingerprint recurs with no release
# in between, the cycle-by-cycle count sequence between the two
# occurrences repeats verbatim — the LRM tie-group "wobble" is periodic.
# The engine then replays whole periods at O(runs) emission cost with no
# allocation or event-horizon work, which is what keeps LRM-contended
# million-cycle problems tractable *without* giving up bit-exactness.
# (Because runs are merged to maximal length, replay fidelity only needs
# the per-cycle counts to repeat — how the original events happened to
# split the period into jumps is irrelevant.)
#
# Safety guards: every moving task must stay in the bulk regime across
# the replay (rem - n_rep*work >= dl — in the tail, delta_eff starts
# shrinking and the fingerprint argument breaks), and the replay must
# stop at the next release (the ready set changes there).

_FP_MAP_LIMIT = 4096


def _bulk_fingerprint(ready: list[_Task]) -> tuple | None:
    """Relative state fingerprint, or None if any task is in its tail."""
    ids = []
    rel_h = []
    phases = []
    h_min = _FAR
    for t in ready:
        dl = t.delta // t.width
        if t.rem < dl:
            return None
        h = -(-t.rem // dl)
        ids.append(t.idx)
        rel_h.append(h)
        phases.append(t.rem - dl * (h - 1))
        if h < h_min:
            h_min = h
    return (tuple(ids), tuple(h - h_min for h in rel_h), tuple(phases))


def _append_run(forward: list[tuple[int, Counts]], tau: int,
                counts: Counts) -> None:
    if forward and forward[-1][1] == counts:
        forward[-1] = (forward[-1][0] + tau, counts)
    else:
        forward.append((tau, counts))


def _fast_forward(ready: list[_Task], forward: list[tuple[int, Counts]],
                  t_now: int, next_release: int | None,
                  entry: tuple) -> int:
    """Replay the detected period as many times as provably safe.

    ``entry`` is (t_prev, {idx: rem}, n_runs, last_tau) recorded when the
    same fingerprint was last seen (with no release in between).  Returns
    the cycles advanced (0 if no safe replay exists); mutates ``forward``
    and the tasks' ``rem``.
    """
    t_prev, rem_prev, n_runs, last_tau = entry
    t_period = t_now - t_prev
    if t_period <= 0:
        return 0
    work = {t.idx: rem_prev[t.idx] - t.rem for t in ready}
    n_rep = _FAR
    if next_release is not None:
        n_rep = (next_release - t_now) // t_period
    for t in ready:
        w = work[t.idx]
        if w <= 0:
            continue
        dl = t.delta // t.width
        n_safe = (t.rem - dl) // w
        if n_safe < n_rep:
            n_rep = n_safe
    if n_rep >= _FAR or n_rep < 1:
        return 0
    period: list[tuple[int, Counts]] = []
    if n_runs > 0 and forward[n_runs - 1][0] > last_tau:
        # the period's first run merged into the run open at record time
        period.append((forward[n_runs - 1][0] - last_tau,
                       forward[n_runs - 1][1]))
    period.extend(forward[n_runs:])
    assert sum(tau for tau, _ in period) == t_period
    for _ in range(n_rep):
        for tau, counts in period:
            _append_run(forward, tau, counts)
    for t in ready:
        t.rem -= n_rep * work[t.idx]
    return n_rep * t_period


# ----------------------------------------------------------------------
# the unified engine
# ----------------------------------------------------------------------
def _run_engine(tasks: list[_Task], m: int, fill_residual: bool,
                per_cycle: bool, *,
                heap: list[tuple[int, int]] | None = None,
                ready: list[_Task] | None = None,
                forward: list[tuple[int, Counts]] | None = None,
                t_now: int = 0) -> list[tuple[int, Counts]]:
    """Event loop shared by both modes; ``per_cycle`` pins tau to 1.

    Releases live in a heap; completions and height-equalizations are
    folded into the jump bound; recurring bulk-regime fingerprints
    trigger the periodic fast-forward.  Consecutive identical allocations
    merge, so both modes emit maximal runs — hence bit-identical layouts.

    The keyword-only state arguments let a warm start resume the loop
    mid-schedule: ``heap`` holds the not-yet-released tasks, ``ready``
    the released ones in (release, idx) order, ``forward`` the runs
    already emitted, and ``t_now`` the resume time.  Defaults reproduce
    a cold start from cycle 0.
    """
    if heap is None:
        heap = [(t.release, i) for i, t in enumerate(tasks)]
    heapq.heapify(heap)
    if forward is None:
        forward = []
    if ready is None:
        ready = []
    # fingerprint -> (t_at, {idx: rem}, n_runs, last_tau); cleared on
    # every release so a period never spans one
    fp_map: dict[tuple, tuple] = {}
    while heap or ready:
        released = False
        while heap and heap[0][0] <= t_now:
            _, i = heapq.heappop(heap)
            ready.append(tasks[i])
            released = True
        if released:
            fp_map.clear()
        ready = [t for t in ready if t.rem > 0]
        if not ready:
            if not heap:
                break
            # idle until the next release; idle cycles are *not* emitted —
            # dropping them in due-date space only reduces lateness
            t_now = heap[0][0]
            continue
        next_release = heap[0][0] if heap else None
        if not per_cycle:
            fp = _bulk_fingerprint(ready)
            if fp is not None:
                ent = fp_map.get(fp)
                if ent is not None:
                    advanced = _fast_forward(ready, forward, t_now,
                                             next_release, ent)
                    if advanced:
                        t_now += advanced
                        fp_map.clear()
                        continue
                if len(fp_map) >= _FP_MAP_LIMIT:
                    fp_map.clear()
                fp_map[fp] = (t_now, {t.idx: t.rem for t in ready},
                              len(forward),
                              forward[-1][0] if forward else 0)
        alloc = _find_capabilities(ready, m, fill_residual)
        assert alloc, "FIND_CAPABILITIES must allocate at least one task"
        tau = 1 if per_cycle else _exact_tau(ready, alloc, next_release,
                                             t_now)
        counts: Counts = tuple(
            (task.idx, beta // task.width) for task, beta in alloc
        )
        _append_run(forward, tau, counts)
        for task, beta in alloc:
            task.rem -= tau * (beta // task.width)
            assert task.rem >= 0
        t_now += tau
    return forward

# ----------------------------------------------------------------------
# incremental re-planning (warm start from a cached near-miss neighbour)
# ----------------------------------------------------------------------
# The engine's state at any release time R is fully determined by the
# per-task remaining elements, the ready order (ascending (release,
# idx)), and t_now = R — the fingerprint map is cleared on every release
# and only accelerates, never alters, the emitted counts.  A cached
# layout therefore lets us *jump* to R: replay its forward trace
# vectorized (one matmul over the run/count matrix) to recover the
# remaining-element vector, copy the prefix runs verbatim, and resume
# the event loop.  This is bit-identical to a cold run provided
#
# * the two problems share m, fill_residual and d_max, and agree on
#   every array except one (substitution, insertion or deletion) — then
#   every common task has the same release and the same tie order, so
#   the cold engine's decisions on [0, R) match the neighbour's, where
#   R is the earliest release at which the problems can diverge;
# * no idle gap was compressed out of the prefix — the cached trace
#   omits idle cycles, so a gap makes trace time lag engine time.  A gap
#   always surfaces as a prefix run scheduling a task before its
#   release (post-gap runs start at a release), which we detect and
#   reject, falling back to a cold run.
#
# Layout construction re-validates full coverage afterwards, so a warm
# start can never silently produce a wrong layout — at worst it falls
# back to the cold path.

def _align_signatures(old: tuple, new: tuple
                      ) -> tuple[str, int] | None:
    """Align two canonical array tuples differing in at most one slot.

    Returns ``(kind, pos)`` with kind in {'sub', 'ins', 'del'} and pos
    the differing index (in the new tuple for 'ins', the old tuple for
    'del'), or None if the tuples are not near-miss neighbours.
    """
    if len(old) == len(new):
        diffs = [i for i, (a, b) in enumerate(zip(old, new)) if a != b]
        if len(diffs) == 1:
            return ("sub", diffs[0])
        return None
    if len(new) == len(old) + 1:
        i = 0
        while i < len(old) and old[i] == new[i]:
            i += 1
        if tuple(old[i:]) == tuple(new[i + 1:]):
            return ("ins", i)
        return None
    if len(new) == len(old) - 1:
        i = 0
        while i < len(new) and old[i] == new[i]:
            i += 1
        if tuple(old[i + 1:]) == tuple(new[i:]):
            return ("del", i)
        return None
    return None


def _replay_tables(layout: Layout) -> tuple:
    """Vectorized replay view of a layout's forward trace (memoized).

    Returns (fwd_runs, tau, cmat, start, rel) where ``cmat[r, j]`` is
    array j's per-cycle element count in forward run r, ``start[r]`` the
    run's first cycle in trace time, and ``rel[j]`` the task release.
    Shared across rebinds via ``Layout._replay_cache``.
    """
    cached = layout._replay_cache.get("replay")
    if cached is None:
        fwd = tuple(reversed(layout.count_intervals))
        n = len(layout.problem.arrays)
        tau = np.fromiter((t for t, _ in fwd), dtype=np.int64,
                          count=len(fwd))
        cmat = np.zeros((len(fwd), n), dtype=np.int64)
        for r, (_tau, counts) in enumerate(fwd):
            for a, e in counts:
                cmat[r, a] += e
        start = np.zeros(len(fwd) + 1, dtype=np.int64)
        np.cumsum(tau, out=start[1:])
        d_max = layout.problem.d_max
        rel = np.fromiter((d_max - a.due for a in layout.problem.arrays),
                          dtype=np.int64, count=n)
        cached = (fwd, tau, cmat, start, rel)
        layout._replay_cache["replay"] = cached
    return cached


def _schedule_warm(prob: LayoutProblem, tasks: list[_Task],
                   per_cycle: bool, fill_residual: bool,
                   neighbor: tuple
                   ) -> tuple[list[tuple[int, Counts]], tuple] | None:
    """Resume the engine from a cached neighbour's state at cycle R.

    ``neighbor`` is (layout, kind, pos, R) from
    :meth:`LayoutCache.find_neighbor`.  Returns ``(forward, replay)`` —
    the complete forward trace for ``prob`` plus ready-made replay
    tables for the *new* layout (derived from the neighbour's by a
    column edit, so chained warm starts never rescan the prefix in
    Python) — or None when the prefix is unusable (idle gap,
    inconsistent remaining work) and the caller must run cold.  Mutates
    ``tasks`` (remaining elements); callers must rebuild them on None.
    """
    lay_old, kind, pos, r_split = neighbor
    fwd, tau, cmat, start, rel_old = _replay_tables(lay_old)
    n_old = cmat.shape[1]
    total = int(start[-1])
    if r_split >= total:
        idx, tau1 = len(fwd), 0
    else:
        idx = int(np.searchsorted(start, r_split, side="right")) - 1
        tau1 = r_split - int(start[idx])
    win = idx + (1 if tau1 > 0 else 0)
    if win > 0:
        # a prefix run scheduling a task before its release ⇒ an idle
        # gap was compressed out of the trace: bail to the cold path
        active = cmat[:win] > 0
        if bool(np.any(active & (rel_old[None, :] > start[:win, None]))):
            return None
    if kind == "del" and win > 0 and bool(np.any(cmat[:win, pos] > 0)):
        return None          # deleted array must not appear in the prefix
    consumed = tau[:idx] @ cmat[:idx]
    if tau1 > 0:
        consumed = consumed + tau1 * cmat[idx]
    if kind == "sub":
        remap = list(range(n_old))
    elif kind == "ins":
        remap = [j if j < pos else j + 1 for j in range(n_old)]
    else:
        remap = [j if j < pos else j - 1 for j in range(n_old)]
        remap[pos] = -1
    for j_old in range(n_old):
        j_new = remap[j_old]
        c = int(consumed[j_old])
        if j_new < 0:
            if c:
                return None
            continue
        tasks[j_new].rem -= c
        if tasks[j_new].rem < 0:
            return None
    if kind == "sub":
        # identity remap: share the neighbour's run tuples verbatim
        forward: list[tuple[int, Counts]] = list(fwd[:idx])
        if tau1 > 0:
            _append_run(forward, tau1, fwd[idx][1])
    else:
        forward = [(int(tau[r]),
                    tuple((remap[a], e) for a, e in fwd[r][1]))
                   for r in range(idx)]
        if tau1 > 0:
            _append_run(forward, tau1,
                        tuple((remap[a], e) for a, e in fwd[idx][1]))
    order = sorted(range(len(tasks)),
                   key=lambda i: (tasks[i].release, i))
    ready = [tasks[i] for i in order if tasks[i].release < r_split]
    heap = [(tasks[i].release, i) for i in order
            if tasks[i].release >= r_split]
    _run_engine(tasks, prob.m, fill_residual, per_cycle,
                heap=heap, ready=ready, forward=forward, t_now=r_split)
    # replay tables for the new layout: prefix rows come from the
    # neighbour's count matrix via a column edit (a seam merge only
    # alters a run's tau, never its counts, so row r < idx still
    # describes forward[r]); only the continuation tail is scanned
    n_new = len(tasks)
    if kind == "sub":
        pre = cmat[:idx]
    elif kind == "ins":
        pre = np.insert(cmat[:idx], pos, 0, axis=1)
    else:
        pre = np.delete(cmat[:idx], pos, axis=1)
    tail = np.zeros((len(forward) - idx, n_new), dtype=np.int64)
    for r in range(idx, len(forward)):
        for a, e in forward[r][1]:
            tail[r - idx, a] += e
    cmat_new = np.vstack([pre, tail])
    tau_new = np.fromiter((t for t, _ in forward), dtype=np.int64,
                          count=len(forward))
    start_new = np.zeros(len(forward) + 1, dtype=np.int64)
    np.cumsum(tau_new, out=start_new[1:])
    rel_new = np.fromiter((t.release for t in tasks), dtype=np.int64,
                          count=n_new)
    replay = (tuple(forward), tau_new, cmat_new, start_new, rel_new)
    return forward, replay


def schedule(problem: LayoutProblem, *, mode: str = "auto",
             fill_residual: bool = False,
             cache: "LayoutCache | None" = None,
             warm_start: bool = True,
             _cycle_limit: int = 1 << 16) -> Layout:
    """Run Iris on ``problem`` and return the due-date-space :class:`Layout`.

    mode: 'cycle' (per-cycle replay, O(C_max)), 'interval' (event-driven,
    O(events)), or 'auto' (cycle below ``_cycle_limit`` estimated cycles).
    Both modes produce bit-identical layouts; they differ only in cost.

    ``cache``: an optional :class:`LayoutCache`; on a hit the scheduler
    does not run at all.  On a miss with ``warm_start=True`` (the
    default), a cached near-miss neighbour — same bus and d_max, one
    array substituted, added or removed — seeds the engine mid-schedule
    (:func:`_schedule_warm`); the result is bit-identical to a cold run,
    and any unusable prefix silently falls back to one.
    """
    if mode not in ("auto", "cycle", "interval"):
        raise ValueError(f"unknown mode {mode!r}")
    if cache is not None:
        hit = cache.lookup(problem, fill_residual)
        if hit is not None:
            return hit
    prob = problem
    d_max = prob.d_max

    def _build_tasks() -> list[_Task]:
        return [
            _Task(
                idx=i,
                width=a.width,
                release=d_max - a.due,
                delta=a.delta(prob.m),
                rem=a.depth,
            )
            for i, a in enumerate(prob.arrays)
        ]

    tasks = _build_tasks()
    if mode == "auto":
        est = sum(t.rem * t.width for t in tasks) / prob.m + d_max
        mode = "cycle" if est <= _cycle_limit else "interval"
    per_cycle = mode == "cycle"

    lay: Layout | None = None
    if warm_start and cache is not None:
        neighbor = cache.find_neighbor(problem, fill_residual)
        if neighbor is not None:
            try:
                res = _schedule_warm(prob, tasks, per_cycle,
                                     fill_residual, neighbor)
                if res is not None:
                    forward, replay = res
                    lay = Layout.from_count_intervals(
                        prob, forward, reverse=True, _normalized=True)
                    lay._replay_cache["replay"] = replay
            except (ValueError, AssertionError):
                lay = None
            if lay is None:
                tasks = _build_tasks()     # warm path mutated the rems
            else:
                cache.warm_starts += 1
    if lay is None:
        forward = _run_engine(tasks, prob.m, fill_residual,
                              per_cycle=per_cycle)
        lay = Layout.from_count_intervals(prob, forward, reverse=True,
                                          _normalized=True)
    if cache is not None:
        cache.insert(problem, fill_residual, lay)
    return lay


# ----------------------------------------------------------------------
# layout cache + batch API
# ----------------------------------------------------------------------
_DISK_CACHE_VERSION = 1


class LayoutCache:
    """Content-addressed LRU cache of solved layout problems.

    Keyed on ``LayoutProblem.canonical_signature()`` (name-independent)
    plus the ``fill_residual`` flag.  Mode is deliberately *not* part of
    the key: the unified engine emits bit-identical layouts in both
    modes, so a layout solved in either mode answers both.  A hit whose
    cached problem differs only in array names is rebound via
    :meth:`Layout.rebind` — O(intervals), no scheduling.

    ``cache_dir`` enables a persistent on-disk tier: inserts write
    through to content-addressed JSON entries (atomic rename), and an
    in-memory miss consults the disk before scheduling.  Loaded entries
    are trusted only after re-verification — payload digest, signature
    match, the Layout constructor's own full-coverage check, and the
    layout-only analysis passes (mirroring the gate
    ``checkpoint.restore_packed`` runs before rebinding streams).  A
    tampered or truncated entry is unlinked and counted in
    ``disk_rejects``; the lookup then proceeds as an ordinary miss.
    """

    def __init__(self, maxsize: int = 256,
                 cache_dir: "str | os.PathLike | None" = None) -> None:
        if maxsize <= 0:
            raise ValueError(f"maxsize must be positive, got {maxsize}")
        self.maxsize = maxsize
        self._store: OrderedDict[tuple, Layout] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.warm_starts = 0
        self.disk_hits = 0
        self.disk_rejects = 0
        self.cache_dir = pathlib.Path(cache_dir) if cache_dir else None
        if self.cache_dir is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def __len__(self) -> int:
        return len(self._store)

    @staticmethod
    def _key(problem: LayoutProblem, fill_residual: bool) -> tuple:
        return (problem.canonical_signature(), bool(fill_residual))

    # -- persistent tier ------------------------------------------------
    @staticmethod
    def _entry_name(key: tuple) -> str:
        blob = json.dumps(key, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:40] + ".json"

    @staticmethod
    def _payload_digest(payload: dict) -> str:
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def _disk_store(self, fill_residual: bool, layout: Layout,
                    key: tuple) -> None:
        payload = {
            "problem": json.loads(layout.problem.to_json()),
            "fill_residual": bool(fill_residual),
            "intervals": [[int(n), [[int(a), int(e)] for a, e in counts]]
                          for n, counts in layout.count_intervals],
        }
        obj = {"version": _DISK_CACHE_VERSION,
               "sha256": self._payload_digest(payload),
               "payload": payload}
        path = self.cache_dir / self._entry_name(key)
        tmp = path.with_suffix(".tmp")
        try:
            tmp.write_text(json.dumps(obj))
            os.replace(tmp, path)
        except OSError as e:  # disk full / permissions: cache stays warm-only
            warnings.warn(f"layout cache: cannot persist {path.name}: {e}",
                          RuntimeWarning, stacklevel=3)

    def _disk_load(self, problem: LayoutProblem, key: tuple) -> Layout | None:
        path = self.cache_dir / self._entry_name(key)
        if not path.exists():
            return None
        try:
            obj = json.loads(path.read_text())
            if obj.get("version") != _DISK_CACHE_VERSION:
                raise ValueError(f"version {obj.get('version')!r}")
            payload = obj["payload"]
            if self._payload_digest(payload) != obj.get("sha256"):
                raise ValueError("payload digest mismatch")
            stored = LayoutProblem.from_json(json.dumps(payload["problem"]))
            if stored.canonical_signature() != problem.canonical_signature():
                raise ValueError("canonical signature mismatch")
            raw = payload["intervals"]
            # enforce the canonical-form contract here so the trusted
            # constructor path is sound on disk data: a malformed run
            # (non-positive or non-integer cycle counts / element
            # counts) is a rejection, not something normalization
            # silently repairs.  Vectorized: dtype kind 'i' proves every
            # value is a plain integer, ragged rows fail np.array.
            taus = np.array([n for n, _c in raw] or [1])
            pairs = [p for _n, counts in raw for p in counts]
            pair_np = (np.array(pairs) if pairs
                       else np.empty((0, 2), dtype=np.int64))
            if (taus.dtype.kind != "i" or bool((taus <= 0).any())
                    or pair_np.dtype.kind != "i" or pair_np.ndim != 2
                    or pair_np.shape[1] != 2
                    or bool((pair_np[:, 1] <= 0).any())):
                raise ValueError("non-canonical count run")
            runs = tuple((n, tuple(map(tuple, counts))) for n, counts in raw)
            # the constructor bounds- and coverage-checks; the analysis
            # gate below re-proves legality independently (validate()
            # would be a third, redundant derivation of the same facts)
            lay = Layout.from_count_intervals(stored, runs,
                                              _normalized=True)
            from ..analysis import verify_layout_fast
            verify_layout_fast(lay, subject=path.name).raise_if_errors()
        except Exception as e:
            self.disk_rejects += 1
            warnings.warn(
                f"layout cache: rejecting persisted entry {path.name}: {e}",
                RuntimeWarning, stacklevel=3)
            try:
                path.unlink()
            except OSError:
                pass
            return None
        return lay

    # -- in-memory tier -------------------------------------------------
    def lookup(self, problem: LayoutProblem,
               fill_residual: bool = False) -> Layout | None:
        key = self._key(problem, fill_residual)
        lay = self._store.get(key)
        if lay is None and self.cache_dir is not None:
            lay = self._disk_load(problem, key)
            if lay is not None:
                self.disk_hits += 1
                self._store[key] = lay
                while len(self._store) > self.maxsize:
                    self._store.popitem(last=False)
        if lay is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return lay.rebind(problem)

    def insert(self, problem: LayoutProblem, fill_residual: bool,
               layout: Layout) -> None:
        key = self._key(problem, fill_residual)
        self._store[key] = layout
        self._store.move_to_end(key)
        while len(self._store) > self.maxsize:
            self._store.popitem(last=False)
        if self.cache_dir is not None:
            self._disk_store(fill_residual, layout, key)

    def find_neighbor(self, problem: LayoutProblem,
                      fill_residual: bool = False) -> tuple | None:
        """Most-recently-used near-miss neighbour of ``problem``.

        A neighbour shares the bus width, fill_residual and d_max, and
        differs in exactly one array (substituted, inserted or removed).
        Returns ``(layout, kind, pos, R)`` where R is the first cycle at
        which the two schedules can diverge, or None.  Problems with a
        different bus width share no engine state (every task's
        parallelism changes), so they are never neighbours.
        """
        new_sig = problem.canonical_signature()
        m, new_arr = new_sig
        if not new_arr:
            return None
        d_max = max(a[2] for a in new_arr)
        for (sig, fr), lay in reversed(self._store.items()):
            if fr != bool(fill_residual) or sig[0] != m or sig == new_sig:
                continue
            old_arr = sig[1]
            if not old_arr or max(a[2] for a in old_arr) != d_max:
                continue
            align = _align_signatures(old_arr, new_arr)
            if align is None:
                continue
            kind, pos = align
            if kind == "sub":
                r_split = d_max - max(old_arr[pos][2], new_arr[pos][2])
            elif kind == "ins":
                r_split = d_max - new_arr[pos][2]
            else:
                r_split = d_max - old_arr[pos][2]
            if r_split <= 0:
                continue
            return (lay, kind, pos, r_split)
        return None

    def clear(self) -> None:
        self._store.clear()
        self.hits = 0
        self.misses = 0
        self.warm_starts = 0
        self.disk_hits = 0
        self.disk_rejects = 0

    @property
    def stats(self) -> dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "size": len(self._store),
            "maxsize": self.maxsize,
            "warm_starts": self.warm_starts,
            "disk_hits": self.disk_hits,
            "disk_rejects": self.disk_rejects,
        }


def _env_default_cache() -> LayoutCache:
    """Build the process-wide cache from the environment.

    ``REPRO_CACHE_SIZE`` sizes the in-memory LRU (default 512);
    ``REPRO_CACHE_DIR``, when set, enables the persistent on-disk tier
    under that directory.  Malformed values fall back to the defaults.
    """
    raw = os.environ.get("REPRO_CACHE_SIZE", "")
    try:
        size = int(raw) if raw else 512
    except ValueError:
        size = 512
    if size <= 0:
        size = 512
    return LayoutCache(maxsize=size,
                       cache_dir=os.environ.get("REPRO_CACHE_DIR") or None)


#: Process-wide cache used by the DSE sweeps, model packing and serving.
DEFAULT_CACHE = _env_default_cache()


# ----------------------------------------------------------------------
# batch API: dedupe + process-pool fan-out
# ----------------------------------------------------------------------
def _schedule_worker(payload: tuple) -> list[tuple]:
    """Pool worker: JSON problems in, due-date-space run traces out.

    Problems within a chunk share a local cache, so contiguous near-miss
    neighbours warm-start each other inside the worker exactly as they
    would serially.  Only plain tuples cross the process boundary.
    """
    texts, mode, fill_residual = payload
    local = LayoutCache(maxsize=max(1, len(texts)))
    out = []
    for text in texts:
        prob = LayoutProblem.from_json(text)
        lay = schedule(prob, mode=mode, fill_residual=fill_residual,
                       cache=local)
        out.append(lay.count_intervals)
    return out


def _effective_workers(workers: int | None, n_unique: int) -> int:
    cores = os.cpu_count() or 1
    if workers is None:
        workers = cores
    return max(1, min(workers, cores, n_unique))


#: seconds a pool may take for one batch before ``schedule_many`` gives
#: up on it (killing the workers) and schedules serially
POOL_TIMEOUT_S = 600.0

#: the directory that holds the ``repro_torch`` package, put on a
#: worker's ``PYTHONPATH``
_PKG_PARENT = str(pathlib.Path(__file__).resolve().parents[2])

#: a pool worker's program: one JSON payload of :func:`_schedule_worker`
#: on stdin, its run traces as JSON on stdout
_WORKER = ("import json, sys\n"
           "from repro_torch.core.iris import _schedule_worker\n"
           "json.dump(_schedule_worker(tuple(json.load(sys.stdin))), "
           "sys.stdout)\n")


def _pool_schedule(probs: list[LayoutProblem], mode: str,
                   fill_residual: bool, workers: int
                   ) -> list[tuple[LayoutProblem, tuple]] | None:
    """Schedule ``probs`` over a pool of worker processes; None if no
    pool works (or it takes longer than :data:`POOL_TIMEOUT_S`).

    Chunks are contiguous so each worker's local cache can warm-start
    chain neighbouring problems, and results merge in input order —
    the outcome is deterministic regardless of completion order.

    The reference forks a ``multiprocessing`` pool.  A process of the
    port has usually started torch's threads (and often CUDA's) by the
    time it plans, and a fork of a multithreaded process may deadlock in
    the child, while a ``spawn`` or ``forkserver`` child re-imports the
    parent's main module (torch with it).  So each worker is a fresh
    interpreter that imports only this package's numpy ``core``: JSON
    problems in on stdin (a temporary file), JSON run traces out on
    stdout.
    """
    per = -(-len(probs) // workers)
    chunks = [probs[i:i + per] for i in range(0, len(probs), per)]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_PKG_PARENT + (
        os.pathsep + path if path else ""))
    procs: list[subprocess.Popen] = []
    try:
        for ch in chunks:
            with tempfile.TemporaryFile("w+") as payload:
                json.dump([[p.to_json() for p in ch], mode,
                           bool(fill_residual)], payload)
                payload.seek(0)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _WORKER], stdin=payload,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    env=env, text=True))
        results = []
        deadline = time.monotonic() + POOL_TIMEOUT_S
        for proc in procs:
            out, err = proc.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            if proc.returncode != 0:
                raise RuntimeError(f"worker exited {proc.returncode}: "
                                   f"{err.strip()[-400:]}")
            results.append([
                tuple((int(n), tuple((int(a), int(e)) for a, e in counts))
                      for n, counts in runs)
                for runs in json.loads(out)])
    except Exception as e:  # no worker could run: schedule serially
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()      # reap it and close its pipes
        warnings.warn(f"schedule_many: process pool unavailable ({e}); "
                      "falling back to serial scheduling",
                      RuntimeWarning, stacklevel=3)
        return None
    out_pairs: list[tuple[LayoutProblem, tuple]] = []
    for ch, runs_list in zip(chunks, results):
        out_pairs.extend(zip(ch, runs_list))
    return out_pairs


def schedule_many(problems: Sequence[LayoutProblem], *, mode: str = "auto",
                  fill_residual: bool = False,
                  cache: LayoutCache | None = DEFAULT_CACHE,
                  workers: int | None = None) -> list[Layout]:
    """Batch API: one scheduler run per *unique* scheduling instance.

    Problems sharing a canonical signature (e.g. every layer of a uniform
    decoder) are scheduled once and rebound; results are returned in
    input order.  ``cache=None`` still dedupes within the batch via an
    ephemeral cache.

    Unique uncached instances fan out over a process pool of
    ``workers`` processes (default: the machine's core count, always
    clamped to it).  Pool results merge into the cache in input order,
    so the cache state — like the returned layouts — is deterministic
    and identical to a serial run's.  With one effective worker, or
    when no pool can be spawned, scheduling is serial; near-miss
    batches still chain warm starts through the shared cache either
    way, and the counters in ``cache.stats`` advance identically in
    every path (one miss per unique instance, one hit per duplicate).
    """
    problems = list(problems)
    local = cache if cache is not None \
        else LayoutCache(maxsize=max(1, len(problems)))
    fresh: "OrderedDict[tuple, LayoutProblem]" = OrderedDict()
    for p in problems:
        key = LayoutCache._key(p, fill_residual)
        if key not in local._store and key not in fresh:
            fresh[key] = p
    eff = _effective_workers(workers, len(fresh))
    pooled: dict[tuple, Layout] = {}
    if eff > 1:
        solved = _pool_schedule(list(fresh.values()), mode, fill_residual,
                                eff)
        if solved is not None:
            for p, runs in solved:
                lay = Layout.from_count_intervals(p, runs, _normalized=True)
                key = LayoutCache._key(p, fill_residual)
                local.insert(p, fill_residual, lay)
                local.misses += 1   # counter parity with the serial path
                pooled[key] = lay
    out: list[Layout] = []
    claimed: set[tuple] = set()
    for p in problems:
        key = LayoutCache._key(p, fill_residual)
        if key in pooled and key not in claimed:
            claimed.add(key)        # first occurrence: no lookup, like serial
            out.append(pooled[key].rebind(p))
        else:
            out.append(schedule(p, mode=mode, fill_residual=fill_residual,
                                cache=local))
    return out
