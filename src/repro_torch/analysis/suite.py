"""The shared verification problem suite.

Own copy of ``src/repro/analysis/suite.py`` for the port, built on
:func:`repro_torch.core.task.make_problem`: the same problems, with the
same canonical signatures.  The deterministic problems that the
``python -m repro_torch.analysis gate`` job iterates: the paper's §4
worked example, non-power-of-two widths/bus, lane-capped arrays, arrays
wider than 32 bits and multi-interval many-release schedules.  The gate
runs **every registered strategy** over every problem here and fails on
any error finding — so a scheduler or lowering regression that produces
an unsound layout is caught by the static analyzer before any kernel
executes it.
"""
from __future__ import annotations

from ..core.task import PAPER_EXAMPLE, LayoutProblem, make_problem

#: §4 worked example, non-power-of-two widths/bus, lane-capped, and a
#: multi-interval many-release problem
EXEC_PROBLEMS: list[LayoutProblem] = [
    PAPER_EXAMPLE,
    make_problem(40, [("a", 3, 41, 4), ("b", 5, 33, 9), ("c", 7, 17, 9)]),
    make_problem(72, [("a", 9, 100, 10), ("b", 12, 50, 3),
                      ("c", 33, 20, 20), ("d", 64, 8, 20)]),
    make_problem(256, [("u", 64, 131, 33), ("S", 64, 21, 3),
                       ("D", 64, 131, 36)], max_lanes=2),
    make_problem(128, [("q", 4, 257, 2), ("s", 16, 31, 2), ("b", 32, 9, 5)]),
]

#: mixed-width kernel-decode problems
DECODE_PROBLEMS: list[LayoutProblem] = [
    make_problem(32, [("a", 3, 40, 4), ("b", 5, 33, 9), ("c", 8, 17, 9)]),
    make_problem(64, [("a", 7, 100, 10), ("b", 12, 50, 3),
                      ("c", 17, 20, 20), ("d", 32, 8, 20)]),
    make_problem(128, [("q", 4, 257, 2), ("s", 16, 31, 2),
                       ("b", 32, 9, 5)]),
]

#: the reference's golden-file canonical problem
GOLDEN_PROBLEM: LayoutProblem = DECODE_PROBLEMS[0]

#: everything the analysis gate iterates (strategy x problem)
GATE_PROBLEMS: list[LayoutProblem] = [*EXEC_PROBLEMS, *DECODE_PROBLEMS]
