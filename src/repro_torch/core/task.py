"""Problem specification for the Iris bus-layout problem.

Own copy of ``src/repro/core/task.py`` (numpy-free, unchanged), kept so
the port imports nothing of the JAX package.

An *array* (paper: "task") is a 1-D stream of ``depth`` elements, each
``width`` bits wide, that must be transferred over an ``m``-bit bus and is
wanted by the accelerator at cycle ``due`` (the due date, derived from the
consumer dataflow graph).  See paper §3 (Table 1) for the notation.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """One input array of the layout problem (paper Table 3 row)."""

    name: str
    width: int           # W_j: element bitwidth
    depth: int           # D_j: number of elements
    due: int             # d_j: due date in bus cycles
    max_lanes: int | None = None  # optional cap on delta_j / W_j (Table 6 sweep)

    def __post_init__(self) -> None:
        if self.width <= 0:
            raise ValueError(f"{self.name}: width must be positive, got {self.width}")
        if self.depth <= 0:
            raise ValueError(f"{self.name}: depth must be positive, got {self.depth}")
        if self.due < 0:
            raise ValueError(f"{self.name}: due date must be >= 0, got {self.due}")
        if self.max_lanes is not None and self.max_lanes <= 0:
            raise ValueError(f"{self.name}: max_lanes must be positive")

    @property
    def processing_time(self) -> int:
        """p_j = W_j * D_j — total bits of the array."""
        return self.width * self.depth

    def delta(self, m: int) -> int:
        """delta_j = floor(m / W_j) * W_j — max bits usable per cycle.

        Optionally clamped to ``max_lanes`` whole elements (paper Table 6's
        delta/W sweep).
        """
        lanes = m // self.width
        if lanes == 0:
            raise ValueError(
                f"{self.name}: element width {self.width} exceeds bus width {m}"
            )
        if self.max_lanes is not None:
            lanes = min(lanes, self.max_lanes)
        return lanes * self.width

    def height(self, m: int) -> int:
        """h(j) = ceil(D_j / (delta_j / W_j)) — min cycles at max parallelism.

        Matches paper Table 4 (h is an integral cycle count).
        """
        lanes = self.delta(m) // self.width
        return -(-self.depth // lanes)


@dataclasses.dataclass(frozen=True)
class LayoutProblem:
    """A full bus-layout problem instance (bus width + arrays)."""

    m: int                       # bus width in bits
    arrays: tuple[ArraySpec, ...]

    def __post_init__(self) -> None:
        if self.m <= 0:
            raise ValueError(f"bus width must be positive, got {self.m}")
        names = [a.name for a in self.arrays]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate array names: {names}")
        if not self.arrays:
            raise ValueError("problem must contain at least one array")
        object.__setattr__(self, "arrays", tuple(self.arrays))

    @property
    def p_tot(self) -> int:
        """Total bits across all arrays (paper: p_tot)."""
        return sum(a.processing_time for a in self.arrays)

    @property
    def d_max(self) -> int:
        return max(a.due for a in self.arrays)

    def release_time(self, a: ArraySpec) -> int:
        """r_j = d_max - d_j (paper §4: due-date -> release-time conversion)."""
        return self.d_max - a.due

    def canonical_signature(self) -> tuple:
        """Name-independent content signature of the problem.

        Two problems with the same signature are the *same scheduling
        instance*: the scheduler's output depends only on the bus width and
        the ordered (width, depth, due, max_lanes) tuples — array names are
        labels.  Input order is part of the signature because the scheduler
        breaks ties by it.  This is the content-address used by
        :class:`repro.core.iris.LayoutCache`.
        """
        return (
            self.m,
            tuple((a.width, a.depth, a.due, a.max_lanes) for a in self.arrays),
        )

    # ---- (de)serialization: the paper's prototype reads a JSON file ----
    def to_json(self) -> str:
        return json.dumps(
            {
                "bus_width": self.m,
                "arrays": [
                    {
                        "name": a.name,
                        "width": a.width,
                        "depth": a.depth,
                        "due": a.due,
                        **(
                            {"max_lanes": a.max_lanes}
                            if a.max_lanes is not None
                            else {}
                        ),
                    }
                    for a in self.arrays
                ],
            },
            indent=2,
        )

    @staticmethod
    def from_json(text: str) -> "LayoutProblem":
        obj = json.loads(text)
        return LayoutProblem(
            m=obj["bus_width"],
            arrays=tuple(
                ArraySpec(
                    name=a["name"],
                    width=a["width"],
                    depth=a["depth"],
                    due=a.get("due", 0),
                    max_lanes=a.get("max_lanes"),
                )
                for a in obj["arrays"]
            ),
        )


def make_problem(
    m: int,
    specs: Sequence[tuple[str, int, int, int]],
    max_lanes: int | None = None,
) -> LayoutProblem:
    """Convenience constructor from (name, width, depth, due) tuples."""
    return LayoutProblem(
        m=m,
        arrays=tuple(
            ArraySpec(name=n, width=w, depth=d, due=dd, max_lanes=max_lanes)
            for (n, w, d, dd) in specs
        ),
    )


#: The worked example of paper §4, Table 3.
PAPER_EXAMPLE = make_problem(
    m=8,
    specs=[
        ("A", 2, 5, 2),
        ("B", 3, 5, 6),
        ("C", 4, 3, 3),
        ("D", 5, 4, 6),
        ("E", 6, 2, 3),
    ],
)

#: Paper Table 5 — Inverse Helmholtz accelerator inputs (m=256 on Alveo u280).
INV_HELMHOLTZ = make_problem(
    m=256,
    specs=[
        ("u", 64, 1331, 333),
        ("S", 64, 121, 31),
        ("D", 64, 1331, 363),
    ],
)


def matmul_problem(w_a: int = 64, w_b: int = 64, depth: int = 625,
                   due: int = 157, m: int = 256) -> LayoutProblem:
    """Paper Table 5/7 — Matrix-Multiplication accelerator inputs."""
    return make_problem(m, [("A", w_a, depth, due), ("B", w_b, depth, due)])
