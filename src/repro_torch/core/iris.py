"""Iris layout scheduler (paper Algorithms 1.1, 1.2, 1.3).

Own copy of ``src/repro/core/iris.py`` for the port: the event-driven
interval engine (``_run_engine`` and the exact event horizon it calls,
reference lines 65-480), :func:`schedule`, and an in-memory
:class:`LayoutCache` (``lookup`` / ``insert`` / ``stats``).  The
process-pool ``schedule_many``, warm-started re-planning and the on-disk
cache tier are not copied yet (ROADMAP.md, queue A).

The bus-layout problem is solved as preemptive multiprocessor scheduling
of linear-speedup tasks (Drozdowski 1996): the m-bit bus is m identical
processors, array j is a task with processing time ``p_j = W_j * D_j``,
maximum parallelism ``delta_j = floor(m/W_j)*W_j``, and release time
``r_j = d_max - d_j``.  The schedule is computed forward in release-time
space and reversed into due-date space to optimize ``L_max``.  The
``interval`` and ``cycle`` modes emit bit-identical layouts.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict

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


def schedule(problem: LayoutProblem, *, mode: str = "auto",
             fill_residual: bool = False,
             cache: "LayoutCache | None" = None,
             _cycle_limit: int = 1 << 16) -> Layout:
    """Run Iris on ``problem`` and return the due-date-space :class:`Layout`.

    mode: 'cycle' (per-cycle replay, O(C_max)), 'interval' (event-driven,
    O(events)), or 'auto' (cycle below ``_cycle_limit`` estimated cycles).
    Both modes produce bit-identical layouts; they differ only in cost.
    On a ``cache`` hit the scheduler does not run at all.
    """
    if mode not in ("auto", "cycle", "interval"):
        raise ValueError(f"unknown mode {mode!r}")
    if cache is not None:
        hit = cache.lookup(problem, fill_residual)
        if hit is not None:
            return hit
    prob = problem
    d_max = prob.d_max
    tasks = [
        _Task(idx=i, width=a.width, release=d_max - a.due,
              delta=a.delta(prob.m), rem=a.depth)
        for i, a in enumerate(prob.arrays)
    ]
    if mode == "auto":
        est = sum(t.rem * t.width for t in tasks) / prob.m + d_max
        mode = "cycle" if est <= _cycle_limit else "interval"
    forward = _run_engine(tasks, prob.m, fill_residual,
                          per_cycle=mode == "cycle")
    lay = Layout.from_count_intervals(prob, forward, reverse=True,
                                      _normalized=True)
    if cache is not None:
        cache.insert(problem, fill_residual, lay)
    return lay


class LayoutCache:
    """Content-addressed in-memory LRU cache of solved layout problems.

    Keyed on ``LayoutProblem.canonical_signature()`` (name-independent)
    plus the ``fill_residual`` flag.  A hit whose cached problem differs
    only in array names is rebound via :meth:`Layout.rebind`.
    """

    def __init__(self, maxsize: int = 256) -> None:
        if maxsize <= 0:
            raise ValueError(f"maxsize must be positive, got {maxsize}")
        self.maxsize = maxsize
        self._store: OrderedDict[tuple, Layout] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(problem: LayoutProblem, fill_residual: bool) -> tuple:
        return (problem.canonical_signature(), bool(fill_residual))

    def lookup(self, problem: LayoutProblem,
               fill_residual: bool = False) -> Layout | None:
        key = self._key(problem, fill_residual)
        lay = self._store.get(key)
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

    @property
    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._store), "maxsize": self.maxsize}


#: Process-wide cache used by model packing and serving (the reference's
#: ``DEFAULT_CACHE``, without its environment-configured disk tier).
DEFAULT_CACHE = LayoutCache(maxsize=512)
