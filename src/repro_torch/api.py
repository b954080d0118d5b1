"""One front door for the Iris layout pipeline, on the port.

Port of ``src/repro/api.py``.  :func:`plan` turns a
:class:`~repro_torch.core.task.LayoutProblem` into a lazy :class:`Plan`
that carries the schedule, metrics, decode program and packed buffers
behind one surface:

    import repro_torch.api as iris

    p = iris.plan(iris.PAPER_EXAMPLE)            # strategy="iris"
    p.metrics.row()                              # C_max / L_max / B_eff
    buf = p.pack(codes, backend="cuda")          # host-side organization
    out = p.decode(buf, backend="cuda")          # accelerator-side read
    src = p.emit(target="c")                     # HLS read_data module

Two registries make the pipeline pluggable:

* **strategies** (:data:`STRATEGIES`) map a problem to a
  :class:`~repro_torch.core.layout.Layout`: ``"iris"`` (the scheduler)
  plus the paper's baselines ``"naive"``, ``"homogeneous"`` and
  ``"hls_padded"``.
* **backends** (:data:`BACKENDS`) execute a plan: ``"numpy"`` is the
  host bit-gatherer, ``"cuda"`` the port's CUDA kernels (``fused=True``:
  ``decode_layout_fused``, one launch; ``fused=False``: the per-slot
  decode of every unit of the decode plan, one launch), ``"c"`` emits the paper's
  Listing 1/2 HLS source.  ``plan.decode`` normalizes every backend's
  output to uint64 numpy arrays, so cross-backend equality is plain
  ``np.array_equal``.  The ``"cuda"`` backend takes ``device=`` and runs
  on the card unless given ``device="cpu"``.

Scheduling routes through the process-wide layout cache by default.
``Plan.verify`` runs the static analyzer (:mod:`repro_torch.analysis`).
The reference's ``Plan.stream_tables`` and ``Plan.matmul_direct`` are
not carried over;
:meth:`repro_torch.tree.PackedTree.matmul_direct` serves stream-direct
matmuls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .core.baselines import ALL_BASELINES
from .core.codegen import (
    DecodePlan,
    decode_plan,
    emit_c_decode,
    emit_c_pack,
    pack_arrays,
    random_codes,
    unpack_arrays,
)
from .core.exec_plan import (
    ExecProgram,
    lower_exec,
    pack_compiled,
    unpack_compiled,
)
from .core.iris import DEFAULT_CACHE, LayoutCache, schedule
from .core.layout import Layout, LayoutMetrics
from .core.registry import Registry
from .core.task import (
    INV_HELMHOLTZ,
    PAPER_EXAMPLE,
    ArraySpec,
    LayoutProblem,
    make_problem,
    matmul_problem,
)
from .plan import LayerStackPlan, plan_layer_stack
from .tree import LayoutManifest, PackedTree, pack_tree, unpack_streams

__all__ = [
    "ArraySpec", "LayoutProblem", "make_problem", "random_codes",
    "PAPER_EXAMPLE", "INV_HELMHOLTZ", "matmul_problem",
    "Backend", "Plan", "LayerStackPlan",
    "STRATEGIES", "BACKENDS", "strategies", "backends",
    "plan", "plan_many", "compare", "plan_layer_stack",
    "ExecProgram", "lower_exec", "pack_compiled", "unpack_compiled",
    "PackedTree", "pack_tree", "unpack_streams", "LayoutManifest",
]


# ----------------------------------------------------------------------
# strategy registry: name -> (problem, **knobs) -> Layout
# ----------------------------------------------------------------------
#: Layout strategies.  A strategy is ``fn(problem, *, mode,
#: fill_residual, cache) -> Layout``; closed-form baselines ignore the
#: scheduling knobs.
STRATEGIES: Registry[Callable[..., Layout]] = Registry("strategy")


def _register_baseline(name: str, fn: Callable[[LayoutProblem], Layout]):
    def run(problem: LayoutProblem, *, mode: str = "auto",
            fill_residual: bool = False,
            cache: LayoutCache | None = None) -> Layout:
        # closed-form baseline: the scheduling knobs don't apply, and it
        # is cheaper than a cache lookup
        return fn(problem)

    run.__name__ = f"strategy_{name}"
    run.__doc__ = fn.__doc__
    STRATEGIES.register(name, run)


for _name, _fn in ALL_BASELINES.items():
    _register_baseline(_name, _fn)
STRATEGIES.register("iris", schedule)


# ----------------------------------------------------------------------
# backend registry: execution targets for a Plan
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Backend:
    """One execution target for a :class:`Plan`.

    ``decode(plan, buf, **kw)`` reverses the packed buffer into per-array
    code streams; ``emit(plan, **kw)`` renders source code.  Unset
    capabilities raise ``NotImplementedError`` naming the backends that
    have them.
    """

    name: str
    decode: Callable[..., dict[str, np.ndarray]] | None = None
    emit: Callable[..., str] | None = None


def _as_u64(out: dict[str, Any]) -> dict[str, np.ndarray]:
    """Normalize backend output to uint64 numpy arrays (cross-backend
    equality is then plain ``np.array_equal``)."""
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).astype(np.uint64)
            for k, v in out.items()}


# backend callables take explicit keywords only: a misspelled option
# must raise TypeError, not silently fall back to a default
def _decode_numpy(pl: "Plan", buf: np.ndarray, *,
                  compiled: bool = True) -> dict[str, np.ndarray]:
    if compiled:
        return _as_u64(unpack_compiled(pl.layout, np.asarray(buf),
                                       program=pl.exec_program))
    return _as_u64(unpack_arrays(pl.layout, np.asarray(buf)))


def _decode_cuda(pl: "Plan", buf, *, fused: bool = True,
                 device=None) -> dict[str, np.ndarray]:
    from .kernels.ops import decode_layout

    if fused:
        return _as_u64(decode_layout(pl.layout, buf, fused=True,
                                     program=pl.exec_program,
                                     device=device))
    return _as_u64(decode_layout(pl.layout, buf, fused=False,
                                 plan=pl.decode_plan, device=device))


def _emit_c(pl: "Plan", *, artifact: str = "decode",
            word_bits: int = 64) -> str:
    if artifact == "decode":
        return emit_c_decode(pl.layout)
    if artifact == "pack":
        return emit_c_pack(pl.layout, word_bits=word_bits)
    if artifact == "both":
        return (emit_c_pack(pl.layout, word_bits=word_bits)
                + "\n\n" + emit_c_decode(pl.layout))
    raise ValueError(
        f"unknown C artifact {artifact!r}; expected 'pack', 'decode' or 'both'"
    )


#: Execution backends.
BACKENDS: Registry[Backend] = Registry("backend")
BACKENDS.register("numpy", Backend("numpy", decode=_decode_numpy))
BACKENDS.register("cuda", Backend("cuda", decode=_decode_cuda))
BACKENDS.register("c", Backend("c", emit=_emit_c))


def strategies() -> list[str]:
    """Registered strategy names, registration order (iris last)."""
    return STRATEGIES.names()


def backends() -> list[str]:
    """Registered backend names."""
    return BACKENDS.names()


# ----------------------------------------------------------------------
# the Plan object
# ----------------------------------------------------------------------
class Plan:
    """Lazy handle over one (problem, strategy) layout pipeline.

    Nothing is scheduled at construction (the strategy name is validated
    eagerly so typos fail fast); the layout materializes on first access
    and is memoized, as are the derived artifacts.  ``cache`` defaults to
    the process-wide ``DEFAULT_CACHE``.
    """

    def __init__(self, problem: LayoutProblem, strategy: str = "iris", *,
                 mode: str = "auto", fill_residual: bool = False,
                 cache: LayoutCache | None = DEFAULT_CACHE) -> None:
        self._strategy_fn = STRATEGIES.get(strategy)   # fail fast on typos
        self.problem = problem
        self.strategy = strategy
        self.mode = mode
        self.fill_residual = fill_residual
        self.cache = cache
        self._layout: Layout | None = None
        self._metrics: LayoutMetrics | None = None
        self._decode_plan: DecodePlan | None = None
        self._exec_program: ExecProgram | None = None
        self._provenance: str | None = None

    # -- lazy pipeline stages ------------------------------------------
    @property
    def layout(self) -> Layout:
        """The scheduled :class:`Layout` (computed on first access)."""
        if self._layout is None:
            hits0 = self.cache.hits if self.cache is not None else 0
            self._layout = self._strategy_fn(
                self.problem, mode=self.mode,
                fill_residual=self.fill_residual, cache=self.cache,
            )
            if self.strategy != "iris":
                self._provenance = "closed-form"
            elif self.cache is not None and self.cache.hits > hits0:
                self._provenance = "cache-hit"
            else:
                self._provenance = "scheduled"
        return self._layout

    @property
    def provenance(self) -> str:
        """``"scheduled"``, ``"cache-hit"`` or ``"closed-form"``
        (``"unscheduled"`` before first access)."""
        return self._provenance or "unscheduled"

    @property
    def metrics(self) -> LayoutMetrics:
        """Paper metrics (C_max, L_max, B_eff, FIFO depths) of the layout."""
        if self._metrics is None:
            self._metrics = self.layout.metrics()
        return self._metrics

    @property
    def decode_plan(self) -> DecodePlan:
        """Static decode program (paper Listing 2 as a table)."""
        if self._decode_plan is None:
            self._decode_plan = decode_plan(self.layout)
        return self._decode_plan

    @property
    def exec_program(self) -> ExecProgram:
        """Compiled execution plan (flat pack/unpack tables and the fused
        decode kernel's slot table), lowered once per layout signature."""
        if self._exec_program is None:
            self._exec_program = lower_exec(self.layout)
        return self._exec_program

    @property
    def c_max(self) -> int:
        return self.layout.c_max

    @property
    def stream_bytes(self) -> int:
        """Size of the packed unified buffer in bytes."""
        return self.layout.c_max * self.problem.m // 8

    # -- uniform execution surface -------------------------------------
    def pack(self, arrays: dict[str, np.ndarray], *,
             compiled: bool = True, backend: str = "numpy",
             device=None) -> np.ndarray:
        """Pack per-array codes into the unified ``(c_max, m/8)`` buffer
        (paper Listing 1).

        ``backend="numpy"`` (default) packs on the host: the vectorized
        :class:`ExecProgram` when ``compiled=True``, the per-slot
        reference path otherwise.  ``backend="cuda"`` runs the fused pack
        kernel (:func:`~repro_torch.kernels.layout_pack.pack_layout_fused`)
        on ``device``.  All paths are byte-identical.
        """
        if backend == "cuda":
            from .kernels.layout_pack import pack_layout_fused

            return pack_layout_fused(self.layout, arrays,
                                     program=self.exec_program,
                                     device=device)
        if backend != "numpy":
            raise NotImplementedError(
                f"backend {backend!r} cannot pack; use 'numpy' or 'cuda'"
            )
        if compiled:
            return pack_compiled(self.layout, arrays,
                                 program=self.exec_program)
        return pack_arrays(self.layout, arrays)

    def decode(self, buf, backend: str = "numpy",
               **kw: Any) -> dict[str, np.ndarray]:
        """Decode a packed buffer through a registered backend.

        Returns ``{name: uint64 ndarray}`` whatever the backend, so
        outputs compare bit-for-bit across backends.
        """
        b = BACKENDS.get(backend)
        if b.decode is None:
            can = [n for n in BACKENDS if BACKENDS.get(n).decode is not None]
            raise NotImplementedError(
                f"backend {backend!r} cannot decode; use one of {can}"
            )
        return b.decode(self, buf, **kw)

    def emit(self, target: str = "c", **kw: Any) -> str:
        """Emit source for a registered backend (e.g. the HLS C module).

        ``target="c"`` accepts ``artifact="decode" | "pack" | "both"``.
        """
        b = BACKENDS.get(target)
        if b.emit is None:
            can = [n for n in BACKENDS if BACKENDS.get(n).emit is not None]
            raise NotImplementedError(
                f"backend {target!r} cannot emit source; use one of {can}"
            )
        return b.emit(self, **kw)

    # -- conveniences ---------------------------------------------------
    def validate(self) -> "Plan":
        """Validate the layout (legal, complete transfer plan); chainable."""
        self.layout.validate()
        return self

    def verify(self, *, raise_on_error: bool = True, passes=None):
        """Run the static layout analyzer over this plan's layout and
        lowered tables (:mod:`repro_torch.analysis`).

        Returns the :class:`~repro_torch.analysis.Report`; with
        ``raise_on_error=True`` (default) any error-severity finding
        raises :class:`~repro_torch.analysis.AnalysisError` naming the
        rule — "verify before you serve".
        """
        from .analysis import verify_layout  # lazy: keep api import lean

        report = verify_layout(
            self.layout, program=self.exec_program, passes=passes,
            subject=f"Plan[{self.strategy}]")
        return report.raise_if_errors() if raise_on_error else report

    def render(self, max_cycles: int = 64) -> str:
        """ASCII rendering in the style of the paper's Figs. 3-5."""
        return self.layout.render(max_cycles=max_cycles)

    def summary(self) -> str:
        """One-line report: strategy, size, B_eff, buffer bytes and cache
        provenance (forces scheduling)."""
        m = self.metrics
        return (
            f"Plan[{self.strategy}] m={self.problem.m}"
            f" arrays={len(self.problem.arrays)}"
            f" C_max={m.c_max} B_eff={m.efficiency:.4f}"
            f" stream={self.stream_bytes / 2**10:.1f} KiB"
            f" cache={self.provenance}"
        )

    def __repr__(self) -> str:
        if self._layout is None:
            return (
                f"Plan({self.strategy!r}, m={self.problem.m}, "
                f"n_arrays={len(self.problem.arrays)}, unscheduled)"
            )
        return f"<{self.summary()}>"


def plan(problem: LayoutProblem, strategy: str = "iris", *,
         mode: str = "auto", fill_residual: bool = False,
         cache: LayoutCache | None = DEFAULT_CACHE) -> Plan:
    """Build a lazy :class:`Plan` for ``problem`` under ``strategy``
    (unknown strategies raise a ``KeyError`` listing the registered
    names)."""
    return Plan(problem, strategy, mode=mode, fill_residual=fill_residual,
                cache=cache)


def plan_many(problems: Sequence[LayoutProblem], strategy: str = "iris", *,
              mode: str = "auto", fill_residual: bool = False,
              cache: LayoutCache | None = DEFAULT_CACHE) -> list[Plan]:
    """Batch :func:`plan`: problems sharing a canonical signature are
    scheduled once (``cache=None`` still dedupes within the batch via an
    ephemeral cache)."""
    if cache is None:
        cache = LayoutCache(maxsize=max(1, len(problems)))
    return [
        Plan(p, strategy, mode=mode, fill_residual=fill_residual, cache=cache)
        for p in problems
    ]


def compare(problem: LayoutProblem,
            strategies: Sequence[str] | None = None, *,
            mode: str = "auto", fill_residual: bool = False,
            cache: LayoutCache | None = DEFAULT_CACHE,
            ) -> dict[str, LayoutMetrics]:
    """Metrics per strategy: the paper's Figs. 3-5 / Tables 6-7 columns.
    Iterates the whole strategy registry unless ``strategies`` narrows
    it."""
    names = list(strategies) if strategies is not None else STRATEGIES.names()
    return {
        name: plan(problem, name, mode=mode, fill_residual=fill_residual,
                   cache=cache).metrics
        for name in names
    }
