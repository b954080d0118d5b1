"""Baseline layouts the paper compares against (Figs. 3 and 4, §6).

Own copy of ``src/repro/core/baselines.py`` for the port.

All baselines are emitted directly in due-date space (no reversal): arrays
are concatenated in increasing-due-date order.
"""
from __future__ import annotations

from .layout import Counts, Layout
from .task import LayoutProblem


def _due_order(problem: LayoutProblem) -> list[int]:
    """Array indices sorted by increasing due date (stable)."""
    return sorted(range(len(problem.arrays)),
                  key=lambda i: (problem.arrays[i].due, i))


def naive_layout(problem: LayoutProblem) -> Layout:
    """Fig. 3: one element per bus word, arrays concatenated by due date.

    Reproduces the paper's 'completely naive' §4 numbers:
    C_max=19, L_max=13, B_eff=45.4%.
    """
    intervals: list[tuple[int, Counts]] = []
    for i in _due_order(problem):
        intervals.append((problem.arrays[i].depth, ((i, 1),)))
    return Layout.from_count_intervals(problem, intervals)


def homogeneous_layout(problem: LayoutProblem) -> Layout:
    """Fig. 4: per-array dense packing, arrays concatenated by due date.

    Each cycle carries ``floor(m/W)`` elements of a single array (the last
    cycle of an array may be partial).  This is the 'packed naive' layout of
    [22] used as the main comparator in §6.  Reproduces C_max=13, L_max=7,
    B_eff=66.3% on the §4 example and the naive columns of Tables 6/7.
    """
    intervals: list[tuple[int, Counts]] = []
    for i in _due_order(problem):
        a = problem.arrays[i]
        lanes = a.delta(problem.m) // a.width
        full, rem = divmod(a.depth, lanes)
        if full:
            intervals.append((full, ((i, lanes),)))
        if rem:
            intervals.append((1, ((i, rem),)))
    return Layout.from_count_intervals(problem, intervals)


def hls_padded_layout(problem: LayoutProblem) -> Layout:
    """What an HLS tool does automatically: pad W to the next power of two.

    Elements are widened to ``2^ceil(log2(W))`` so the bus divides into
    equal lanes, then packed homogeneously.  Models the 'HLS-optimized'
    comparator of §1 (bus width evenly divisible by data width).  Efficiency
    still counts only the true ``p_tot`` bits, so padding shows up as waste.
    """
    intervals: list[tuple[int, Counts]] = []
    for i in _due_order(problem):
        a = problem.arrays[i]
        padded = 1 << max(0, (a.width - 1).bit_length())
        padded = min(padded, problem.m)
        lanes = max(1, problem.m // padded)
        if a.max_lanes is not None:
            lanes = min(lanes, a.max_lanes)
        full, rem = divmod(a.depth, lanes)
        if full:
            intervals.append((full, ((i, lanes),)))
        if rem:
            intervals.append((1, ((i, rem),)))
    # NOTE: bit offsets inside the Layout are computed with the TRUE widths,
    # so the layout object remains a valid dense plan; the padding cost is
    # modelled in the cycle count (lanes per cycle), which is what drives
    # every metric.
    return Layout.from_count_intervals(problem, intervals)


ALL_BASELINES = {
    "naive": naive_layout,
    "homogeneous": homogeneous_layout,
    "hls_padded": hls_padded_layout,
}
