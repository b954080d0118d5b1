"""Pipeline parallelism: GPipe-style microbatching over a 'stage' mesh axis.

Port of ``src/repro/runtime/pipeline_par.py``.  The schedule is the
classic loop: with S stages and M microbatches, run S + M - 1 ticks; in
tick t, stage s processes microbatch t - s.  The stage-to-stage handoff,
the reference's ``jax.lax.ppermute`` over the 'stage' axis, is a ring of
``torch.distributed`` point-to-point ops (``batch_isend_irecv``) over the
mesh's 'stage' dim, and the final ``psum`` that shares the last stage's
outputs is an ``all_reduce``.

Bubble fraction = (S - 1) / (S + M - 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..pytree import tree_map


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_microbatches: int

    @property
    def n_ticks(self) -> int:
        return self.n_stages + self.n_microbatches - 1

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / self.n_ticks


def _stage_slice(a, stage: int):
    """This stage's params: the local shard of a DTensor placed over
    'stage' (leading dim 1), or row ``stage`` of a plain tensor."""
    from ..models.shard_utils import is_dtensor

    if is_dtensor(a):
        return a.to_local()[0]
    return a[stage]


def pipeline_forward(stage_fn: Callable, mesh, cfg: PipelineConfig,
                     stage_params, x_microbatches: torch.Tensor
                     ) -> torch.Tensor:
    """Run microbatches through a linear pipeline of stages.

    stage_fn(params_for_stage, x) -> x           (same shape)
    mesh: a ``DeviceMesh`` with a 'stage' dim of ``cfg.n_stages`` ranks
    stage_params: tree with leading dim n_stages (plain, or DTensors
      sharded over 'stage')
    x_microbatches: (M, mb, ...) microbatched input (the same on every
      rank)
    Returns (M, mb, ...) outputs after all stages, on every rank.
    """
    s, m = cfg.n_stages, cfg.n_microbatches
    assert x_microbatches.shape[0] == m
    if mesh["stage"].size() != s:
        raise ValueError(f"mesh has {mesh['stage'].size()} stages, "
                         f"config says {s}")
    stage_id = mesh.get_local_rank("stage")
    group = mesh.get_group("stage")
    nxt = dist.get_global_rank(group, (stage_id + 1) % s)
    prv = dist.get_global_rank(group, (stage_id - 1) % s)
    params = tree_map(lambda a: _stage_slice(a, stage_id), stage_params)
    xs = x_microbatches
    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(cfg.n_ticks):
        # stage 0 ingests microbatch t (if any); others use the carry
        if stage_id == 0:
            cur = xs[t] if t < m else torch.zeros_like(buf)
        else:
            cur = buf
        active = t >= stage_id and t - stage_id < m
        y = stage_fn(params, cur) if active else torch.zeros_like(buf)
        # the last stage writes finished microbatch t - (S-1)
        if stage_id == s - 1 and t >= s - 1:
            outs[t - (s - 1)] = y
        # hand off to the next stage (ring; last -> first unused)
        if s == 1:
            buf = y
        else:
            buf = torch.empty_like(y)
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                    dist.P2POp(dist.irecv, buf, prv, group)]):
                w.wait()
    # only the last stage holds real outputs; share them back
    if stage_id != s - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs


def schedule_table(cfg: PipelineConfig) -> list[list[int | None]]:
    """tick x stage table of microbatch ids (None = bubble)."""
    table = []
    for t in range(cfg.n_ticks):
        row = []
        for stg in range(cfg.n_stages):
            mb = t - stg
            row.append(mb if 0 <= mb < cfg.n_microbatches else None)
        table.append(row)
    return table
