"""Counted costs of a step, in place of XLA's compiled cost analysis.

The reference reads its dry-run costs from XLA: ``compiled.cost_analysis``
and ``memory_analysis``, and three parsers of the optimized HLO text
(``launch/hlo_cost.py``, ``launch/hlo_tools.py`` and
``roofline.collective_bytes``).  The port produces no HLO, so it counts:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the step
  run on meta tensors (forward, backward with the remat recompute and
  AdamW for train; forward for prefill; one ``decode_step`` for decode).
  Like ``hlo_cost`` it counts matmul FLOPs (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, attention), 2 per multiply-add.
* **HBM bytes**: the input and output bytes of every aten op of the same
  run (:class:`OpCounter`), views and other ops that move no data left
  out.  Eager PyTorch fuses nothing, so this is what the port moves
  without fusion; XLA's count skips fused interiors.
* **op histogram / largest tensors**: over the ops the run recorded.
* **peak live bytes**: the most bytes held at once by tensors the step
  made (activations, saved tensors, gradients, the new state: the
  port's step does not donate its input state).
* **collective bytes**: from the placements, one formula per kind
  (:func:`collective_stats`).

A meta run costs Python time per op, and the flash attention's blocks
and the linear recurrences' token loops make many ops at long
sequences.  Every period of a model has the same shapes, so a cost is
affine in the number of periods (and in the encoder's depth):
:func:`count_cell` runs the step at one and two periods (one and two
encoder layers) and extrapolates each count to the config's depth,
exactly for FLOPs, bytes and the histogram; the peak is extrapolated the
same way (the per-period saved activations add up linearly).

Data-dependent shapes would stop a meta run.  The step functions have
none on these paths: ``moe.dispatch`` makes its capacity from the
config (``moe_capacity``) and its slots with ``one_hot`` / ``cumsum``,
the KV write clamps its index instead of branching, and no ``.item()``
or ``nonzero`` runs.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

#: ops that only re-describe storage (no bytes move)
_NO_DATA = {
    "view", "_unsafe_view", "alias", "as_strided", "t", "transpose",
    "permute", "expand", "slice", "select", "unsqueeze", "squeeze",
    "detach", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "diagonal", "view_as_real", "view_as_complex", "unfold", "lift_fresh",
    "_reshape_alias", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "scalar_tensor",
    "arange", "set_", "resolve_conj", "resolve_neg",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Records, for every aten op that runs under it: its input and
    output bytes (summed into ``hbm_bytes``), a count per op name, the
    largest outputs, and the peak bytes of live tensors it made."""

    def __init__(self, top: int = 25):
        super().__init__()
        self.hbm_bytes = 0
        self.n_ops = 0
        self.hist: collections.Counter = collections.Counter()
        self.top = top
        self.largest: list[tuple[int, str]] = []
        self.live = 0
        self.peak = 0
        self._seen: set[int] = set()

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._seen.discard(key)

    def _track(self, t: torch.Tensor) -> None:
        # one storage counted once, freed when its last tensor goes
        base = t._base if t._base is not None else t
        key = id(base)
        if key in self._seen:
            return
        n = base.untyped_storage().nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(base, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        self.n_ops += 1
        self.hist[name] += 1
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if name.rstrip("_") not in _NO_DATA:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            for t in outs:
                b = _nbytes(t)
                if len(self.largest) < self.top or b > self.largest[-1][0]:
                    self.largest.append(
                        (b, f"{name} {tuple(t.shape)} {t.dtype}"))
                    self.largest.sort(key=lambda x: -x[0])
                    del self.largest[self.top:]
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class StepCost:
    flops: float
    hbm_bytes: float
    peak_live_bytes: float
    n_ops: int
    op_histogram: dict[str, int]
    largest_tensors: list[tuple[int, str]]
    output_bytes: float = 0.0

    def combine(self, other: "StepCost", k: float) -> "StepCost":
        """``self + k * other`` count by count (the largest tensors are
        ``self``'s)."""
        hist = collections.Counter(self.op_histogram)
        for op, n in other.op_histogram.items():
            hist[op] += k * n
        return StepCost(self.flops + k * other.flops,
                        self.hbm_bytes + k * other.hbm_bytes,
                        self.peak_live_bytes + k * other.peak_live_bytes,
                        int(round(self.n_ops + k * other.n_ops)),
                        {op: int(round(n)) for op, n in hist.most_common()},
                        self.largest_tensors,
                        self.output_bytes + k * other.output_bytes)

    def minus(self, other: "StepCost") -> "StepCost":
        return self.combine(other, -1.0)


def count(fn: Callable, *args) -> StepCost:
    """Run ``fn(*args)`` (on meta tensors, typically) and count it."""
    with FlopCounterMode(display=False) as fc, OpCounter() as oc:
        out = fn(*args)
    out_bytes = sum(_nbytes(t) for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor))
    return StepCost(float(fc.get_total_flops()), float(oc.hbm_bytes),
                    float(oc.peak), oc.n_ops,
                    dict(oc.hist.most_common()), list(oc.largest),
                    float(out_bytes))


# ----------------------------------------------------------------------
# the step of a cell, counted at one and two periods and extrapolated
# ----------------------------------------------------------------------
def step_fn(cfg, shape, *, remat: str = "full",
            opt_dtype: str = "float32") -> tuple[Callable, tuple]:
    """The cell's step and its meta inputs for ``cfg`` (any depth)."""
    from . import specs, steps

    if shape.kind == "train":
        state = specs.abstract_train_state(cfg, opt_dtype)
        batch = specs.train_batch_specs(cfg, shape)
        return steps.build_train_step(cfg, remat=remat), (state, batch)
    if shape.kind == "prefill":
        params = specs.abstract_params(cfg)
        batch = specs.prefill_batch_specs(cfg, shape)
        return steps.build_prefill_step(cfg), (params, batch)
    params = specs.abstract_params(cfg)
    spec = specs.decode_state_specs(cfg, shape)
    args = (params, spec["state"], spec["tokens"])
    if "cross_kv" in spec:
        args += (spec["cross_kv"],)
    return steps.build_serve_step(cfg), args


#: sequence lengths the fits run at: a multiple of the flash attention's
#: 1024-wide blocks (and of every recurrence's chunk), so that each
#: count is a polynomial in S over these points and the target
_FIT_S = (1024, 2048, 3072)
_FIT_S_LINEAR = (32, 64)
#: the S past which a train or prefill cell's counts are fit over S
FIT_ABOVE = 3072


def _fit(points: list, x: float) -> StepCost:
    """The Lagrange polynomial through ``points`` (x, cost), at ``x``."""
    out = None
    for i, (xi, ci) in enumerate(points):
        w = 1.0
        for j, (xj, _) in enumerate(points):
            if j != i:
                w *= (x - xj) / (xi - xj)
        out = ci.combine(ci, w - 1.0) if out is None else out.combine(ci, w)
    return out


def count_cell(cfg, shape, *, remat: str = "full",
               opt_dtype: str = "float32") -> StepCost:
    """The counted cost of one step of ``cfg`` at ``shape`` (global, on
    meta tensors).

    Each count is affine in the number of periods (and of encoder
    layers): the step runs at one and two periods and is extrapolated to
    the config's depth.  For a train or prefill cell longer than 3072
    tokens each count is also a polynomial in S: quadratic where
    attention runs (at S = 1024, 2048 and 3072, multiples of the flash
    attention's blocks), linear in an attention-free model (S = 32 and
    64, multiples of the recurrence's chunk); the step runs at those S
    and the fit is read at the cell's S.  Decode cells take one token
    and run at their own S.  The fits are exact for FLOPs, bytes and
    op counts at an S that is a multiple of 1024; the peak is fit the
    same way, an estimate.  Cells of at most ``FIT_ABOVE`` tokens run
    at their own S."""
    runs = plan_runs(cfg, shape)
    return assemble(cfg, shape, runs, [
        run_one(cfg, shape, *r, remat=remat, opt_dtype=opt_dtype)
        for r in runs])


def plan_runs(cfg, shape) -> list[tuple[int, int | None, int]]:
    """The (periods, encoder layers, S) of the runs :func:`count_cell`
    makes."""
    if shape.kind == "decode" or shape.seq_len <= FIT_ABOVE:
        pts = (shape.seq_len,)
    else:
        pts = _FIT_S_LINEAR if cfg.attention_free else _FIT_S
    enc = 1 if cfg.encoder is not None else None
    out = []
    for s in pts:
        out += [(1, enc, s), (2, enc, s)]
        if enc is not None:
            out.append((1, 2, s))
    return out


def run_one(cfg, shape, n_p: int, n_enc: int | None, s: int, *,
            remat: str = "full", opt_dtype: str = "float32") -> StepCost:
    """One counted run: ``cfg`` at ``n_p`` periods (``n_enc`` encoder
    layers) and sequence length ``s``.  A module-level function, so a
    process pool can run the runs of many cells side by side."""
    c = dataclasses.replace(cfg, n_layers=n_p * max(1, cfg.attn_every))
    if n_enc is not None:
        c = dataclasses.replace(c, encoder=dataclasses.replace(
            c.encoder, n_layers=n_enc))
    sh = dataclasses.replace(shape, seq_len=s)
    fn, args = step_fn(c, sh, remat=remat, opt_dtype=opt_dtype)
    return count(fn, *args)


def assemble(cfg, shape, runs: list, costs: list[StepCost]) -> StepCost:
    """The cell's cost from its runs' (:func:`plan_runs`) costs."""
    from ..models.transformer import n_periods

    by = dict(zip(runs, costs))
    enc = 1 if cfg.encoder is not None else None

    def at_depth(s: int) -> StepCost:
        c1, c2 = by[(1, enc, s)], by[(2, enc, s)]
        total = c2.combine(c2.minus(c1), n_periods(cfg) - 2)
        if enc is not None:
            total = total.combine(by[(1, 2, s)].minus(c1),
                                  cfg.encoder.n_layers - 1)
        return total

    pts = sorted({s for _, _, s in runs})
    if len(pts) == 1:
        return at_depth(pts[0])
    fits = [(p, at_depth(p)) for p in pts]
    out = _fit(fits, shape.seq_len)
    # the peak's phase can change with S (activations against the
    # optimizer's state): never below the largest run's
    out.peak_live_bytes = max(out.peak_live_bytes,
                              max(c.peak_live_bytes for _, c in fits))
    return out


# ----------------------------------------------------------------------
# collectives, from the placements
# ----------------------------------------------------------------------
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def _axes_of(spec) -> set[str]:
    out: set[str] = set()
    for entry in spec:
        if entry is None:
            continue
        out.update((entry,) if isinstance(entry, str) else entry)
    return out


def collective_stats(cfg, shape, mesh, params, p_shard, *,
                     fsdp: bool):
    """Per-card collective bytes of one step, one formula per kind
    (ring algorithms: an all-gather or reduce-scatter over n cards moves
    (n-1)/n of the gathered tensor through each card, an all-reduce
    twice that):

    * FSDP all-gather over 'data' of every parameter leaf sharded over
      'data': once in the forward, and for train once more for the
      backward (the remat recompute reuses it);
    * gradients (train): a reduce-scatter over the DP axes of each leaf
      sharded over 'data', an all-reduce over them of every other leaf;
    * TP (a 'model' axis above 1): an all-reduce over 'model' of the
      activations (B/dp, S, d) after each sublayer's mixer and dense
      FFN, once in the forward, three times for train (forward,
      recompute, backward);
    * MoE (experts over 'model'), as the port's ``apply_moe`` does it
      and not as the reference's all-to-all: each card dispatches and
      combines its own B/dp rows with no collective; the combine
      all-gathers the expert outputs (B/dp, E, C+1, d) over 'model' in
      each forward (twice for train: forward and recompute), and for
      train the backward all-gathers the dispatch buffer's gradient
      (B/dp, E, C, d) the same way.

    The dense terms model the FSDP / TP design; DTensor's propagation
    picks its own redistributions, which a run on meta tensors without
    a process group cannot record.  The packed serve is not counted
    (the dry run places no ``PackedTree``; a placed one is served
    whole, ``PackedTree.gathered``).  Sizes are the per-card shards of
    the placements (``NamedSharding.shard_shape``).  Returns a
    ``CollectiveStats``."""
    from ..pytree import flatten
    from .mesh import axis_sizes, dp_axes, mesh_axis_size
    from .roofline import CollectiveStats

    sizes = axis_sizes(mesh)
    dp = mesh_axis_size(mesh, dp_axes(mesh))
    n_data = sizes.get("data", 1)
    n_model = sizes.get("model", 1)
    train = shape.kind == "train"
    by = {k: 0.0 for k in _KINDS}
    cnt = {k: 0 for k in _KINDS}

    def ring(n: int) -> float:
        return (n - 1) / n if n > 1 else 0.0

    for leaf, sh in zip(flatten(params), flatten(p_shard)):
        axes = _axes_of(sh.spec)
        local = math.prod(sh.shard_shape(leaf.shape)) * leaf.element_size()
        if "data" in axes and n_data > 1:
            gathered = local * n_data
            passes = 2 if train else 1
            by["all-gather"] += passes * ring(n_data) * gathered
            cnt["all-gather"] += passes
        if train:
            full_dp = local * (n_data if "data" in axes else 1)
            if "data" in axes and dp > 1:
                by["reduce-scatter"] += ring(dp) * full_dp
                cnt["reduce-scatter"] += 1
            elif dp > 1:
                by["all-reduce"] += 2 * ring(dp) * full_dp
                cnt["all-reduce"] += 1
    b = shape.global_batch // dp if shape.global_batch % dp == 0 \
        else shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    elt = torch.tensor([], dtype=getattr(torch, cfg.dtype)).element_size()
    act = b * s * cfg.d_model * elt
    mult = 3 if train else 1
    if n_model > 1:
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        n_sub = 2 * cfg.n_layers
        if n_moe and not cfg.moe.dense_residual_ff:
            n_sub -= n_moe                  # no dense FFN in those layers
        if cfg.encoder is not None:
            n_sub += 2 * cfg.encoder.n_layers + cfg.n_layers   # + cross
        by["all-reduce"] += mult * n_sub * 2 * ring(n_model) * act
        cnt["all-reduce"] += mult * n_sub
        if n_moe:
            from ..models.moe import moe_capacity

            cap = moe_capacity(s, cfg)
            slot = b * cfg.moe.n_experts * cfg.d_model * elt  # (B/dp, E, d)
            fwd = 2 if train else 1
            by["all-gather"] += (n_moe * ring(n_model) * slot
                                 * (fwd * (cap + 1) + (cap if train else 0)))
            cnt["all-gather"] += n_moe * (fwd + int(train))
    return CollectiveStats({k: int(v) for k, v in by.items()}, cnt)
