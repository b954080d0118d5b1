"""Layer-bundle planning: parameter bundles -> Iris problems -> layouts.

Own copy of ``src/repro/core/packing.py`` (:class:`BundleTensor`,
:class:`PackedBundle`, :func:`layer_bundle_spec`, :func:`bundle_problem`,
:func:`pack_bundle`, :func:`serving_stream_report`) and of the
reference's ``LayerStackPlan`` / ``plan_layer_stack`` from
``src/repro/api.py``, which :mod:`repro_torch.api` re-exports.

A transformer layer's parameters are a bundle of heterogeneous-width
arrays (int-N weight codes, bf16 scale patterns, bf16 norm vectors)
consumed at different points of the layer dataflow.  Each bundle is one
Iris problem: bus width ``m`` = one burst line (default 4096 bits), due
dates from the consuming op's dataflow stage.  Every layer of a uniform
stack poses the same scheduling instance, so a stack costs one scheduler
run (zero on a warm cache) plus N-1 cache hits.  Everything here is host
planning; :meth:`LayerStackPlan.matmul_direct` hands the device work to
:meth:`repro_torch.api.Plan.matmul_direct`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core.codegen import decode_plan
from .core.exec_plan import ExecProgram, StreamTables, lower_exec, \
    pack_compiled
from .core.iris import DEFAULT_CACHE, LayoutCache, schedule_many
from .core.layout import Layout
from .core.task import ArraySpec, LayoutProblem
from .core.util import pad_bundle_elements
from .quant import QuantSpec


@dataclasses.dataclass(frozen=True)
class BundleTensor:
    """One member of a layer bundle."""

    name: str
    width_bits: int
    n_elems: int
    stage: int             # dataflow stage (0 = needed first)


@dataclasses.dataclass
class PackedBundle:
    problem: LayoutProblem
    layout: Layout
    buffer: np.ndarray | None       # (c_max, m//8) uint8, None if plan-only
    metrics_iris: dict
    metrics_homogeneous: dict
    metrics_padded: dict
    #: compiled execution plan at bundle-element granularity (piece width
    #: = each tensor's width_bits); shared via the layout's exec cache
    exec_program: ExecProgram | None = None

    @property
    def stream_bytes(self) -> int:
        return self.layout.c_max * self.problem.m // 8

    def decode_plan(self):
        return decode_plan(self.layout)

    def unpack(self, buf: np.ndarray | None = None) -> dict[str, np.ndarray]:
        """Element-granularity codes from a packed buffer (vectorized).

        Tensors are padded up to whole scheduling units; trailing pad
        elements decode as zeros.
        """
        buf = self.buffer if buf is None else buf
        if buf is None:
            raise ValueError("bundle was planned without data")
        out = self.exec_program.unpack_indexed(np.asarray(buf))
        names = [a.name for a in self.problem.arrays]
        return {names[i]: v for i, v in out.items()}


def layer_bundle_spec(d_model: int, d_ff: int, n_heads: int,
                      n_kv_heads: int, head_dim: int,
                      qspec: QuantSpec) -> list[BundleTensor]:
    """The bundle for one dense decoder layer under weight quantization."""
    g = qspec.group_size
    out: list[BundleTensor] = []

    def w(name, d_in, d_out, stage):
        out.append(BundleTensor(name, qspec.bits, d_in * d_out, stage))
        out.append(BundleTensor(f"{name}_scales", 16,
                                (d_in // g) * d_out, stage))

    out.append(BundleTensor("attn_norm", 16, d_model, 0))
    w("wq", d_model, n_heads * head_dim, 1)
    w("wk", d_model, n_kv_heads * head_dim, 1)
    w("wv", d_model, n_kv_heads * head_dim, 1)
    w("wo", n_heads * head_dim, d_model, 2)
    out.append(BundleTensor("mlp_norm", 16, d_model, 3))
    w("w_gate", d_model, d_ff, 4)
    w("w_up", d_model, d_ff, 4)
    w("w_down", d_ff, d_model, 5)
    return out


def bundle_problem(bundle: list[BundleTensor], m: int = 4096,
                   lanes_target: int = 16) -> LayoutProblem:
    """Build the Iris problem for a bundle.

    Arrays are scheduled in *units* of consecutive elements sized so
    ~``lanes_target`` units fit one bus line; due dates are the
    proportional allocation of the ideal stream time by cumulative stage
    work (the paper's dataflow-derived due dates).
    """
    arrays = []
    p_tot_bits = sum(b.width_bits * b.n_elems for b in bundle)
    total_cycles = max(1, p_tot_bits // m)
    stage_bits: dict[int, int] = {}
    for b in bundle:
        stage_bits[b.stage] = stage_bits.get(b.stage, 0) \
            + b.width_bits * b.n_elems
    cum = 0
    stage_due: dict[int, int] = {}
    for s in sorted(stage_bits):
        cum += stage_bits[s]
        stage_due[s] = max(1, int(total_cycles * cum / p_tot_bits))
    for b in bundle:
        unit = max(1, m // (lanes_target * b.width_bits))
        depth = -(-b.n_elems // unit)
        width = b.width_bits * unit
        arrays.append(ArraySpec(
            name=b.name, width=width, depth=depth, due=stage_due[b.stage]))
    return LayoutProblem(m=m, arrays=tuple(arrays))


def pack_bundle(bundle: list[BundleTensor], m: int = 4096,
                data: dict[str, np.ndarray] | None = None,
                mode: str = "auto",
                cache: LayoutCache | None = DEFAULT_CACHE) -> PackedBundle:
    """Schedule (and optionally pack, on the host) one layer bundle.

    Layer bundles of uniform decoder stacks are identical scheduling
    instances, so the shared ``cache`` makes every layer after the first
    (and every repeated serving request) a cache hit.  The program's
    piece width is each tensor's ``width_bits``, so element data packs
    directly.
    """
    from . import api   # deferred: api imports this module

    prob = bundle_problem(bundle, m=m)
    pl = api.plan(prob, "iris", mode=mode, cache=cache).validate()
    lay = pl.layout
    ew = tuple(b.width_bits for b in bundle)
    prog = lower_exec(lay, elem_widths=ew)
    buf = None
    if data is not None:
        buf = pack_compiled(lay, pad_bundle_elements(prob, prog, data),
                            program=prog)
    baselines = api.compare(prob, strategies=("homogeneous", "hls_padded"))
    return PackedBundle(
        problem=prob,
        layout=lay,
        buffer=buf,
        metrics_iris=pl.metrics.row(),
        metrics_homogeneous=baselines["homogeneous"].row(),
        metrics_padded=baselines["hls_padded"].row(),
        exec_program=prog,
    )


def _next_pow2(w: int) -> int:
    return 1 << (w - 1).bit_length()


def _per_tensor_cycles(width: int, n_elems: int, m: int) -> int:
    """Bus lines for one tensor stored alone (line-aligned buffer)."""
    lanes = max(1, m // width)
    return -(-n_elems // lanes)


def serving_stream_report(cfg, qspec: QuantSpec, m: int = 4096,
                          cache: LayoutCache | None = DEFAULT_CACHE) -> dict:
    """Bytes-per-layer comparison for decode-step weight streaming.

    Baselines at *element* granularity, as deployments store them:
    ``bf16`` (2 B an element), ``padded`` (codes in the next power-of-two
    container, one line-aligned buffer per tensor), ``homogeneous``
    (dense bit-packing per tensor, one line-aligned buffer each) and
    ``iris`` (the unified stream: dense packing plus dataflow-ordered
    interleaving, which also lowers L_max and decode staging).
    """
    from . import api   # deferred: api imports this module

    stack = plan_layer_stack(cfg, qspec, m=m, n_layers=1, cache=cache)
    bundle = stack.bundle
    pl = stack.plans[0]
    unit_metrics = api.compare(stack.problem, strategies=("homogeneous",))
    p_tot_bits = sum(b.width_bits * b.n_elems for b in bundle)
    n_elems = sum(b.n_elems for b in bundle)
    hom_cycles = sum(
        _per_tensor_cycles(b.width_bits, b.n_elems, m) for b in bundle)
    pad_cycles = sum(
        _per_tensor_cycles(_next_pow2(b.width_bits), b.n_elems, m)
        for b in bundle)
    line_b = m / 8
    iris_row = pl.metrics.row()
    hom_row = unit_metrics["homogeneous"].row()
    return {
        "arch": cfg.name,
        "bits": qspec.bits,
        "useful_MiB_per_layer": p_tot_bits / 8 / 2**20,
        "iris_MiB_per_layer": stack.stream_bytes_per_layer / 2**20,
        "homogeneous_MiB_per_layer": hom_cycles * line_b / 2**20,
        "padded_MiB_per_layer": pad_cycles * line_b / 2**20,
        "bf16_MiB_per_layer": n_elems * 2 / 2**20,
        "iris_efficiency": iris_row["B_eff"],
        "homogeneous_efficiency": p_tot_bits / (hom_cycles * m),
        "padded_efficiency": p_tot_bits / (pad_cycles * m),
        "iris_L_max": iris_row["L_max"],
        "homogeneous_unit_L_max": hom_row["L_max"],
        "iris_unit_fifo": sum(iris_row["FIFO"].values()),
        "homogeneous_unit_fifo": sum(hom_row["FIFO"].values()),
        "n_decode_units": pl.decode_plan.n_units,
    }


@dataclasses.dataclass(frozen=True)
class LayerStackPlan:
    """Per-layer Iris stream plans for a uniform decoder stack.

    ``plans`` holds one resolved :class:`repro_torch.api.Plan` per layer;
    every layer of a uniform stack poses the same scheduling instance, so
    they share the first layer's count runs.  ``scheduler_runs`` /
    ``cache_hits`` are the counter deltas incurred by the planning call
    (a warm cache yields ``scheduler_runs == 0``).
    """

    problem: LayoutProblem          # one layer's bundle problem
    bundle: tuple                   # the BundleTensors the problem encodes
    plans: tuple                    # one resolved api.Plan per layer
    scheduler_runs: int
    cache_hits: int
    strategy: str = "iris"

    @property
    def n_layers(self) -> int:
        return len(self.plans)

    @property
    def layouts(self) -> tuple[Layout, ...]:
        return tuple(pl.layout for pl in self.plans)

    @property
    def layout(self) -> Layout:
        return self.plans[0].layout

    @property
    def provenance(self) -> str:
        """``"scheduled"``, ``"cache-hit"`` or ``"closed-form"``: where
        the first layer's layout came from."""
        return self.plans[0].provenance

    @property
    def c_max_per_layer(self) -> int:
        return self.layout.c_max

    @property
    def b_eff(self) -> float:
        return self.problem.p_tot / (self.c_max_per_layer * self.problem.m)

    @property
    def stream_bytes_per_layer(self) -> int:
        return self.c_max_per_layer * self.problem.m // 8

    @property
    def elem_widths(self) -> tuple[int, ...]:
        return tuple(b.width_bits for b in self.bundle)

    def exec_program(self) -> ExecProgram:
        """Execution plan at bundle-element granularity (piece width =
        each tensor's ``width_bits``); shared by every layer."""
        return lower_exec(self.layout, elem_widths=self.elem_widths)

    def stream_tables(self, name: str,
                      shape: tuple[int, int]) -> StreamTables:
        """Stream-direct matmul tables for bundle tensor ``name``.

        Resolves the paired ``{name}_scales`` tensor and derives the
        quantization group size from the bundle element counts, so
        callers hand in only the weight name and its ``(K, N)`` shape.
        All layers share the tables (one layout signature).
        """
        by_name = {b.name: b for b in self.bundle}
        if name not in by_name:
            raise KeyError(f"no bundle tensor named {name!r}")
        sname = f"{name}_scales"
        if sname not in by_name:
            raise KeyError(f"bundle tensor {name!r} has no paired scales")
        w, s = by_name[name], by_name[sname]
        k, n = shape
        if k * n != w.n_elems:
            raise ValueError(
                f"{name}: shape {shape} has {k * n} elements, bundle "
                f"holds {w.n_elems}"
            )
        if w.n_elems % s.n_elems:
            raise ValueError(
                f"{name}: scale count {s.n_elems} does not divide "
                f"weight count {w.n_elems}"
            )
        return self.plans[0].stream_tables(
            name, shape, scales=sname, group_size=w.n_elems // s.n_elems,
            elem_widths=self.elem_widths)

    def matmul_direct(self, x, buf, name: str, shape: tuple[int, int], *,
                      device=None):
        """Stream-direct ``x @ dequant(name)`` against one layer's buffer.

        ``buf`` is that layer's packed stream (uint8 rows, or the flat
        words of :func:`~repro_torch.kernels.stream_matmul.stream_words`).
        Any bundle element width <= 32 works, including the widths
        ``packed_matmul`` cannot lane-pack.  Runs where
        :meth:`repro_torch.api.Plan.matmul_direct` runs it.
        """
        tabs = self.stream_tables(name, shape)
        return self.plans[0].matmul_direct(
            x, buf, name, shape, scales=f"{name}_scales",
            group_size=tabs.group_size, elem_widths=self.elem_widths,
            device=device)


def plan_layer_stack(cfg, qspec: QuantSpec | None, *, m: int = 4096,
                     n_layers: int | None = None, mode: str = "auto",
                     strategy: str = "iris",
                     cache: LayoutCache | None = DEFAULT_CACHE,
                     bundle=None) -> LayerStackPlan:
    """Plan the per-layer weight-stream layouts for a model config.

    ``cfg`` is any object with ``d_model / d_ff / n_heads / n_kv_heads /
    head_dim`` (and ``n_layers`` unless passed explicitly).  ``"iris"``
    plans through :func:`~repro_torch.core.iris.schedule_many` (one
    scheduler run, or zero on a warm cache, plus N-1 rebinds); baseline
    strategies are closed-form and computed once outright.  ``bundle``
    overrides the scheduled tensor set (how the KV cache plans its
    per-page stream through the same path).
    """
    from .api import Plan, plan   # deferred: api imports this module

    if bundle is None:
        bundle = layer_bundle_spec(cfg.d_model, cfg.d_ff, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim, qspec)
    prob = bundle_problem(bundle, m=m)
    n = int(cfg.n_layers if n_layers is None else n_layers)
    if n <= 0:
        raise ValueError(f"n_layers must be positive, got {n}")
    local = cache if cache is not None else LayoutCache(maxsize=1)
    hits0, misses0 = local.hits, local.misses
    if strategy == "iris":
        layouts = schedule_many([prob] * n, mode=mode, cache=local)
    else:
        lay0 = plan(prob, strategy, mode=mode, cache=None).layout
        layouts = [lay0] * n
    plans = []
    for i, lay in enumerate(layouts):
        pl = Plan(prob, strategy, mode=mode, cache=local)
        pl._layout = lay
        if strategy != "iris":
            pl._provenance = "closed-form"
        else:
            pl._provenance = "cache-hit" if (i or local.misses == misses0) \
                else "scheduled"
        plans.append(pl)
    # every layer shares the first layout's count runs; validating one
    # validates the stack
    plans[0].validate()
    return LayerStackPlan(
        problem=prob,
        bundle=tuple(bundle),
        plans=tuple(plans),
        scheduler_runs=local.misses - misses0,
        cache_hits=local.hits - hits0,
        strategy=strategy,
    )
