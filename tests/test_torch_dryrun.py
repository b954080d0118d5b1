"""The port's dry run (A15b) against the reference's.

* ``launch/specs``: the meta parameters, AdamW state and every cell's
  inputs have the shapes and dtypes of the reference's ``eval_shape``
  stand-ins, for every config and shape cell.
* ``launch/roofline``: ``model_flops`` equals the reference's exactly on
  every cell when the configs count their active parameters as the
  reference does (the port's own count is exact, the reference's leaves
  a few leaves out); ``roofline_terms`` equals the reference's under the
  reference's constants.
* ``launch/cost``: the counted FLOPs of reduced smollm and moonshot
  train / prefill / decode steps against the reference's
  ``hlo_cost.analyze`` of the same jitted step: train and decode within
  ``FLOP_RTOL``, and every cell equal (within ``EXACT_RTOL``) once the
  two named differences are taken out — the reference's loss contracts
  the logits with a one-hot (2·B·S·V FLOPs the port's gather does not
  spend), and the port's prefill projects K and V twice when it collects
  the caches (XLA merges the two; 8-10% of these reduced prefills).
  The fits of ``count_cell`` equal a direct count.
* ``launch/dryrun``: a cell on a (4, 4) mesh communicates; the CLI
  writes its JSON.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shape_cells as ref_shape_cells
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import roofline as ref_rl
from repro.launch import specs as ref_specs
from repro_torch import configs as pc
from repro_torch.launch import cost
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as ps
from repro_torch.pytree import flatten, leaf_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: counted FLOPs against hlo_cost, as they are
FLOP_RTOL = 0.01
#: ... and with the named differences taken out
EXACT_RTOL = 1e-9


@pytest.fixture(autouse=True)
def _nothing_left_behind():
    yield
    from repro_torch.models.shard_utils import active_mesh

    assert not torch.distributed.is_initialized()
    assert active_mesh() is None


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(x.shape), np.dtype(x.dtype).name)
            for path, x in flat]


def _port_leaves(tree):
    return [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in zip(leaf_paths(tree), flatten(tree))]


@pytest.mark.parametrize("arch", pc.ARCH_IDS)
def test_meta_specs_match_reference(arch):
    rcfg, pcfg = ref_get_config(arch), pc.get_config(arch)
    rstate = ref_specs.abstract_train_state(rcfg)
    pstate = ps.abstract_train_state(pcfg)
    assert all(x.device.type == "meta" for x in flatten(pstate))
    assert _port_leaves(pstate) == _ref_leaves(rstate)
    assert _port_leaves(ps.abstract_train_state(pcfg, "bfloat16")) == \
        _ref_leaves(ref_specs.abstract_train_state(rcfg, "bfloat16"))
    for rshape in ref_shape_cells(arch):
        pshape = pc.SHAPES[rshape.name]
        assert _port_leaves(ps.input_specs(pcfg, pshape)) == \
            _ref_leaves(ref_specs.input_specs(rcfg, rshape)), rshape.name


def _with_ref_active_count(monkeypatch, rcfg):
    """The port's configs count their active parameters as ``rcfg``
    does, for the rest of the test."""
    monkeypatch.setattr(pc.ModelConfig, "active_param_count",
                        lambda self: rcfg.active_param_count())


@pytest.mark.parametrize("arch", pc.ARCH_IDS)
def test_model_flops_match_reference(arch, monkeypatch):
    rcfg, pcfg = ref_get_config(arch), pc.get_config(arch)
    _with_ref_active_count(monkeypatch, rcfg)
    for rshape in ref_shape_cells(arch):
        pshape = pc.SHAPES[rshape.name]
        assert rl.model_flops(pcfg, pshape) == \
            ref_rl.model_flops(rcfg, rshape), rshape.name


def test_roofline_terms_match_reference(monkeypatch):
    # the H100's figures by default, not the TPU's
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 50e9)
    rng = np.random.default_rng(0)
    monkeypatch.setattr(rl, "PEAK_FLOPS", ref_rl.PEAK_FLOPS)
    monkeypatch.setattr(rl, "HBM_BW", ref_rl.HBM_BW)
    monkeypatch.setattr(rl, "LINK_BW", ref_rl.ICI_BW)
    for _ in range(20):
        flops, byts, mf = (float(v) for v in 10.0 ** rng.uniform(6, 16, 3))
        coll = {"all-reduce": int(rng.integers(0, 10**12)),
                "all-gather": int(rng.integers(0, 10**10))}
        n = int(rng.choice([1, 16, 256, 512]))
        ref = ref_rl.roofline_terms(
            {"flops": flops, "bytes accessed": byts},
            ref_rl.CollectiveStats(coll, {k: 1 for k in coll}), n, mf)
        port = rl.roofline_terms(
            {"flops": flops, "bytes accessed": byts},
            rl.CollectiveStats(coll, {k: 1 for k in coll}), n, mf)
        assert port.as_dict() == ref.as_dict()


@functools.lru_cache(maxsize=None)
def _hlo_flops(arch, kind, b, s):
    from repro.launch.hlo_cost import analyze
    from repro.launch.steps import (
        build_prefill_step,
        build_serve_step,
        build_train_step,
    )

    cfg = ref_get_config(arch).reduced()
    shape = RefShape("cell", s, b, kind)
    if kind == "train":
        fn = build_train_step(cfg)
        args = (ref_specs.abstract_train_state(cfg),
                ref_specs.train_batch_specs(cfg, shape))
    elif kind == "prefill":
        fn = build_prefill_step(cfg)
        args = (ref_specs.abstract_params(cfg),
                ref_specs.prefill_batch_specs(cfg, shape))
    else:
        fn = build_serve_step(cfg)
        spec = ref_specs.decode_state_specs(cfg, shape)
        args = (ref_specs.abstract_params(cfg), spec["state"],
                spec["tokens"])
    return analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["smollm-135m", "moonshot-v1-16b-a3b"])
def test_counted_flops_match_hlo_cost(arch, kind):
    b, s = 2, 64
    cfg = pc.get_config(arch).reduced()
    counted = cost.count_cell(cfg, pc.ShapeConfig("cell", s, b, kind)).flops
    ref = _hlo_flops(arch, kind, b, s)
    if kind != "prefill":
        assert counted == pytest.approx(ref, rel=FLOP_RTOL)
    named = 0.0
    if kind == "train":
        # the reference's one-hot contraction of the f32 logits
        named -= 2.0 * b * s * cfg.vocab_size
    if kind == "prefill":
        # the port projects K and V once more to collect the caches
        n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
        named += n_attn * 2 * (2.0 * b * s * cfg.d_model
                               * cfg.n_kv_heads * cfg.head_dim)
    assert counted - named == pytest.approx(ref, rel=EXACT_RTOL)


@pytest.mark.parametrize("arch,kind,s,points", [
    ("smollm-135m", "train", 4096, None),
    ("jamba-1.5-large-398b", "prefill", 512, (128, 256, 384)),
    ("rwkv6-3b", "prefill", 256, None)])
def test_count_cell_fit_equals_a_direct_count(arch, kind, s, points,
                                              monkeypatch):
    """Past ``FIT_ABOVE`` tokens ``count_cell`` fits its counts over S
    and the depth; the fit reads the same FLOPs, bytes and ops as one
    run of the whole config at the cell's S.  smollm at the production
    points (1024, 2048, 3072); jamba (attention, the Mamba scan, MoE) at
    smaller points inside one flash-attention block, to keep it cheap;
    rwkv6-3b at its linear points (32, 64)."""
    if points is not None:
        monkeypatch.setattr(cost, "_FIT_S", points)
    monkeypatch.setattr(cost, "FIT_ABOVE", {"rwkv6-3b": 128}.get(
        arch, cost._FIT_S[-1]))
    cfg = pc.get_config(arch).reduced()
    shape = pc.ShapeConfig("cell", s, 1, kind)
    assert len(cost.plan_runs(cfg, shape)) > 2
    fit = cost.count_cell(cfg, shape)
    fn, args = cost.step_fn(cfg, shape)
    direct = cost.count(fn, *args)
    assert fit.flops == direct.flops
    assert fit.hbm_bytes == pytest.approx(direct.hbm_bytes, rel=5e-3)
    assert fit.n_ops == pytest.approx(direct.n_ops, rel=5e-3)


def test_sharded_cell_communicates():
    """The dry run on a (4, 4) mesh of a reduced MoE config (the
    reference's ``TestMiniDryRun``): every roofline term positive."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import AbstractMesh

    r = run_cell("moonshot-v1-16b-a3b", "train_4k", False, None,
                 fsdp=True, reduced=True,
                 shape=pc.ShapeConfig("train_4k", 128, 8, "train"),
                 mesh=AbstractMesh((4, 4), ("data", "model")))
    assert r["status"] == "ok" and r["n_chips"] == 16
    assert r["cost"]["flops"] > 0 and r["memory"]["temp_bytes"] > 0
    coll = r["collectives"]["bytes_by_kind"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    # MoE: the combine's gathers over 'model', no all-to-all (each card
    # dispatches its own rows)
    assert coll["all-reduce"] > 0 and coll["all-to-all"] == 0
    assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                           "collective")
    assert r["roofline"]["compute_s"] > 0
    # without FSDP every all-gather is the MoE combine's: one a forward
    # pass (forward, recompute) and one in the backward, a MoE layer
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.models.moe import moe_capacity

    cfg = pc.get_config("moonshot-v1-16b-a3b").reduced().with_tp(4)
    shape = pc.ShapeConfig("train_4k", 128, 8, "train")
    params = ps.abstract_params(cfg)
    mesh = AbstractMesh((4, 4), ("data", "model"))
    coll = cost.collective_stats(cfg, shape, mesh, params,
                                 param_shardings(params, mesh, fsdp=False),
                                 fsdp=False)
    cap, rows = moe_capacity(128, cfg), 8 // 4
    slot = rows * cfg.moe.n_experts * cfg.d_model * 2        # bf16
    assert coll.count_by_kind["all-gather"] == 3 * cfg.n_layers
    assert coll.bytes_by_kind["all-gather"] == int(
        cfg.n_layers * 0.75 * slot * (2 * (cap + 1) + cap))


def test_dryrun_cli_writes_its_json(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--reduced", "--out",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK   smollm-135m x decode_32k x single" in out.stdout
    (f,) = tmp_path.glob("*.json")
    assert f.name == "smollm-135m__decode_32k__pod16x16.json"
    r = json.loads(f.read_text())
    assert r["status"] == "ok" and r["n_chips"] == 256
    for key in ("memory", "cost", "collectives", "roofline"):
        assert key in r
    cfg = pc.get_config("smollm-135m").reduced().with_tp(16)
    assert r["roofline"]["model_flops_total"] == rl.model_flops(
        cfg, pc.SHAPES["decode_32k"])

