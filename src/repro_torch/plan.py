"""Layer-bundle planning: parameter bundles -> Iris problems -> layouts.

Own copy of ``src/repro/core/packing.py:47-150`` (:class:`BundleTensor`,
:func:`layer_bundle_spec`, :func:`bundle_problem`) and of
``src/repro/api.py:plan_layer_stack``, calling the port's own
:func:`~repro_torch.core.iris.schedule` and layout cache directly.

A transformer layer's parameters are a bundle of heterogeneous-width
arrays (int-N weight codes, bf16 scale patterns, bf16 norm vectors)
consumed at different points of the layer dataflow.  Each bundle is one
Iris problem: bus width ``m`` = one burst line (default 4096 bits), due
dates from the consuming op's dataflow stage.  Every layer of a uniform
stack poses the same scheduling instance, so a stack costs one scheduler
run (zero on a warm cache) plus N-1 cache hits.
"""
from __future__ import annotations

import dataclasses

from .core.exec_plan import ExecProgram, lower_exec
from .core.iris import DEFAULT_CACHE, LayoutCache, schedule
from .core.layout import Layout
from .core.task import ArraySpec, LayoutProblem
from .quant import QuantSpec


@dataclasses.dataclass(frozen=True)
class BundleTensor:
    """One member of a layer bundle."""

    name: str
    width_bits: int
    n_elems: int
    stage: int             # dataflow stage (0 = needed first)


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


@dataclasses.dataclass(frozen=True)
class LayerStackPlan:
    """Per-layer Iris stream layouts for a uniform decoder stack.

    ``scheduler_runs`` / ``cache_hits`` are the counter deltas incurred by
    the planning call (a warm cache yields ``scheduler_runs == 0``).
    """

    problem: LayoutProblem          # one layer's bundle problem
    bundle: tuple                   # the BundleTensors the problem encodes
    layouts: tuple[Layout, ...]     # one layout per layer (shared runs)
    provenance: str                 # "scheduled" or "cache-hit"
    scheduler_runs: int
    cache_hits: int

    @property
    def n_layers(self) -> int:
        return len(self.layouts)

    @property
    def layout(self) -> Layout:
        return self.layouts[0]

    @property
    def c_max_per_layer(self) -> int:
        return self.layouts[0].c_max

    @property
    def b_eff(self) -> float:
        return self.problem.p_tot / (self.c_max_per_layer * self.problem.m)

    @property
    def stream_bytes_per_layer(self) -> int:
        return self.c_max_per_layer * self.problem.m // 8

    def exec_program(self) -> ExecProgram:
        """Execution plan at bundle-element granularity (piece width =
        each tensor's ``width_bits``); shared by every layer."""
        ew = tuple(b.width_bits for b in self.bundle)
        return lower_exec(self.layouts[0], elem_widths=ew)


def plan_layer_stack(cfg, qspec: QuantSpec | None, *, m: int = 4096,
                     n_layers: int | None = None, mode: str = "auto",
                     cache: LayoutCache | None = DEFAULT_CACHE,
                     bundle=None) -> LayerStackPlan:
    """Plan the per-layer weight-stream layouts for a model config.

    ``cfg`` is any object with ``d_model / d_ff / n_heads / n_kv_heads /
    head_dim`` (and ``n_layers`` unless passed explicitly).  ``bundle``
    overrides the scheduled tensor set (how the KV cache plans its
    per-page stream through the same path).
    """
    if bundle is None:
        bundle = layer_bundle_spec(cfg.d_model, cfg.d_ff, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim, qspec)
    prob = bundle_problem(bundle, m=m)
    n = int(cfg.n_layers if n_layers is None else n_layers)
    if n <= 0:
        raise ValueError(f"n_layers must be positive, got {n}")
    local = cache if cache is not None else LayoutCache(maxsize=1)
    hits0, misses0 = local.hits, local.misses
    layouts = tuple(schedule(prob, mode=mode, cache=local)
                    for _ in range(n))
    # every layer shares the first layout's count runs; validating one
    # validates the stack
    layouts[0].validate()
    return LayerStackPlan(
        problem=prob,
        bundle=tuple(bundle),
        layouts=layouts,
        provenance="scheduled" if local.misses > misses0 else "cache-hit",
        scheduler_runs=local.misses - misses0,
        cache_hits=local.hits - hits0,
    )
