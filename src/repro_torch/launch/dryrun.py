"""Multi-pod dry run: count every (arch x shape x mesh) cell.

Port of ``src/repro/launch/dryrun.py``.  For each cell the reference
jits the step with production shardings, compiles it against
ShapeDtypeStruct inputs and reads XLA's memory and cost analyses.  The
port runs the step on meta tensors over an abstract production mesh
(``launch/mesh.AbstractMesh``) and counts (``launch/cost.py``):

* ``memory``: argument bytes per card, exactly, from the placements of
  the sharding rules (each leaf's local shard); temp bytes, the counted
  peak of live bytes of the step divided over the cards (activations
  shard over every axis: an estimate); output bytes likewise;
* ``cost``: the counted FLOPs and HBM bytes of the global step;
* ``collectives``: per-card bytes by kind, from the placements;
* ``roofline``: the three terms per card (FLOPs and bytes divided by the
  card count) with the H100's figures, and MODEL_FLOPS.

No process group, no card, no ``XLA_FLAGS``.  Artifacts are JSON under
``--out`` (default ``artifacts/torch_dryrun``).

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single
  python -m repro_torch.launch.dryrun --arch jamba-1.5-large-398b --shape long_500k --mesh multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import time
import traceback

#: an H100's memory, per card (what "fits" is held against)
HBM_BYTES = 80 * 10**9
#: the most processes the counted runs spread over (each holds a meta
#: step of its own)
MAX_WORKERS = 8


def _cell_config(arch: str, shape_name: str, *, multi_pod: bool,
                 kv_replicate: bool, kv_dtype: str, reduced: bool,
                 shape=None, mesh=None):
    from ..configs import SHAPES, get_config
    from .mesh import make_production_mesh

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, abstract_only=True)
    shape = shape or SHAPES[shape_name]
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if kv_replicate:
        # GQA TP practice: replicate KV heads to a multiple of the model
        # axis (kv_replicate=False keeps the true head count and lets the
        # rules fall back to head_dim sharding)
        cfg = cfg.with_tp(mesh.shape["model"])
    if kv_dtype != "bfloat16":
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    return cfg, shape, mesh


def _placements(cfg, shape, mesh, fsdp: bool, opt_dtype: str):
    """(argument bytes per card, params, their shardings) of the cell."""
    from .sharding import (
        argument_bytes,
        batch_sharding,
        decode_state_shardings,
        opt_state_shardings,
        param_shardings,
    )
    from .specs import abstract_params, abstract_train_state, input_specs

    if shape.kind == "train":
        state = abstract_train_state(cfg, opt_dtype)
        params = state["params"]
        p_shard = param_shardings(params, mesh, fsdp=fsdp)
        o_shard = opt_state_shardings(state["opt"], p_shard, mesh)
        batch = input_specs(cfg, shape)["batch"]
        args = argument_bytes(state, {"params": p_shard, "opt": o_shard})
        args += argument_bytes(batch, batch_sharding(batch, mesh))
        return args, params, p_shard
    params = abstract_params(cfg)
    p_shard = param_shardings(params, mesh, fsdp=fsdp)
    args = argument_bytes(params, p_shard)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)["batch"]
        return (args + argument_bytes(batch, batch_sharding(batch, mesh)),
                params, p_shard)
    spec = input_specs(cfg, shape)
    shard_seq = shape.global_batch == 1
    args += argument_bytes(spec["state"], decode_state_shardings(
        spec["state"], mesh, shard_seq=shard_seq))
    args += argument_bytes(spec["tokens"],
                           batch_sharding(spec["tokens"], mesh))
    if "cross_kv" in spec:
        cross = {"cross_kv": spec["cross_kv"]}
        args += argument_bytes(cross, decode_state_shardings(
            cross, mesh, shard_seq=shard_seq))
    return args, params, p_shard


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path | None, remat: str = "full",
             fsdp: bool | None = None, opt_dtype: str = "float32",
             kv_dtype: str = "bfloat16", tag: str = "",
             kv_replicate: bool = True, *, reduced: bool = False,
             shape=None, mesh=None, costs=None) -> dict:
    """Count one cell and write its JSON under ``out_dir`` (if given).

    ``shape`` / ``mesh``: a ``ShapeConfig`` and an ``AbstractMesh`` to
    use instead of ``SHAPES[shape_name]`` and the production mesh;
    ``reduced``: the arch's reduced config; ``costs``: the counted runs'
    costs when a caller ran them already (:func:`run_cells`)."""
    from . import cost as cst
    from . import roofline as rl
    from .mesh import mesh_size

    t0 = time.time()
    cfg, shape, mesh = _cell_config(
        arch, shape_name, multi_pod=multi_pod, kv_replicate=kv_replicate,
        kv_dtype=kv_dtype, reduced=reduced, shape=shape, mesh=mesh)
    # FSDP for >= 8B params (everything smaller fits replicated-over-data)
    if fsdp is None:
        fsdp = cfg.param_count() > 8e9
    n_chips = mesh_size(mesh)
    arg_bytes, params, p_shard = _placements(cfg, shape, mesh, fsdp,
                                             opt_dtype)
    runs = cst.plan_runs(cfg, shape)
    if costs is None:
        costs = [cst.run_one(cfg, shape, *r, remat=remat,
                             opt_dtype=opt_dtype) for r in runs]
    sc = cst.assemble(cfg, shape, runs, costs)
    coll = cst.collective_stats(cfg, shape, mesh, params, p_shard,
                                fsdp=fsdp)
    mf = rl.model_flops(cfg, shape)
    terms = rl.roofline_terms(
        {"flops": sc.flops / n_chips,
         "bytes accessed": sc.hbm_bytes / n_chips}, coll, n_chips, mf)
    temp = int(sc.peak_live_bytes // n_chips)
    mesh_name = _mesh_name(mesh)
    result = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "n_chips": n_chips,
        "kind": shape.kind,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "fsdp": fsdp,
        "remat": remat,
        "opt_dtype": opt_dtype,
        "kv_dtype": kv_dtype,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "count_s": round(time.time() - t0, 1),
        "counted_runs": [list(r) for r in runs],
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": int(sc.output_bytes // n_chips),
            "temp_bytes": temp,
            "peak_bytes": arg_bytes + temp,
            "fits_80gb": arg_bytes + temp <= HBM_BYTES,
        },
        "cost": {"flops": sc.flops, "bytes accessed": sc.hbm_bytes,
                 "n_ops": sc.n_ops,
                 "op_histogram": dict(list(sc.op_histogram.items())[:20]),
                 "largest_tensors": sc.largest_tensors[:10]},
        "collectives": {
            "bytes_by_kind": coll.bytes_by_kind,
            "count_by_kind": coll.count_by_kind,
            "total_bytes": coll.total_bytes,
        },
        "roofline": terms.as_dict(),
        "status": "ok",
    }
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{shape.name}__{mesh_name}"
        if tag:
            name += f"__{tag}"
            result["tag"] = tag
        (out_dir / f"{name}.json").write_text(json.dumps(result, indent=2))
    return result


def _pool_run(job):
    from . import cost as cst

    cfg, shape, run, kw = job
    return cst.run_one(cfg, shape, *run, **kw)


def _run_jobs(jobs: list, n_cells: int) -> list:
    """Each job's cost, or the exception it raised, over a pool of at
    most ``MAX_WORKERS`` processes, one per core and per cell (one cell
    runs in this process: spawning workers costs more than its runs)."""
    workers = min(MAX_WORKERS, os.cpu_count() or 1, n_cells)
    if workers <= 1:
        out = []
        for job in jobs:
            try:
                out.append(_pool_run(job))
            except Exception as e:  # noqa: BLE001 — the cell reports it
                out.append(e)
        return out
    import concurrent.futures as cf
    import multiprocessing as mp

    with cf.ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn")) as ex:
        # the slowest runs first, so they do not start last
        order = sorted(range(len(jobs)),
                       key=lambda i: -jobs[i][2][-1] * jobs[i][2][0])
        futs = {i: ex.submit(_pool_run, jobs[i]) for i in order}
        return [futs[i].exception() or futs[i].result()
                for i in range(len(jobs))]


def _mesh_name(mesh) -> str:
    return "pod" + "x".join(str(n) for n in mesh.shape.values())


def _error(arch: str, shape_name: str, multi_pod: bool,
           out_dir: pathlib.Path | None, e: BaseException) -> dict:
    """The result of a cell whose count failed (its JSON written too)."""
    from .mesh import make_production_mesh

    mesh_name = _mesh_name(make_production_mesh(multi_pod=multi_pod,
                                                abstract_only=True))
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "error", "error": str(e)[:2000]}
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}__{mesh_name}.json").write_text(
            json.dumps(result, indent=2))
    print(f"FAIL {arch} x {shape_name} x {mesh_name}: "
          f"{type(e).__name__}: {str(e)[:300]}", flush=True)
    traceback.print_exception(e)
    return result


def run_cells(cells: list[tuple[str, str]], multi_pod: bool,
              out_dir: pathlib.Path | None, **kw) -> list[dict]:
    """:func:`run_cell` over ``cells`` ((arch, shape name) pairs), the
    counted runs of all of them spread over one pool.  A cell whose
    count fails gets a ``status: error`` result (and JSON); the others
    go on."""
    from . import cost as cst

    remat, opt_dtype = kw.get("remat", "full"), kw.get("opt_dtype",
                                                        "float32")
    plans: list = []
    for arch, shape_name in cells:
        try:
            cfg, shape, _ = _cell_config(
                arch, shape_name, multi_pod=multi_pod,
                kv_replicate=kw.get("kv_replicate", True),
                kv_dtype=kw.get("kv_dtype", "bfloat16"),
                reduced=kw.get("reduced", False))
            plans.append((cfg, shape, cst.plan_runs(cfg, shape)))
        except Exception as e:  # noqa: BLE001 — the cell reports it
            plans.append(e)
    jobs = []
    for plan in plans:
        if not isinstance(plan, Exception):
            cfg, shape, runs = plan
            jobs += [(cfg, shape, r, {"remat": remat,
                                      "opt_dtype": opt_dtype})
                     for r in runs]
    costs = iter(_run_jobs(jobs, len(cells)))
    out = []
    for (arch, shape_name), plan in zip(cells, plans):
        try:
            if isinstance(plan, Exception):
                raise plan
            mine = [next(costs) for _ in plan[2]]
            for c in mine:
                if isinstance(c, Exception):
                    raise c
            out.append(run_cell(arch, shape_name, multi_pod, out_dir,
                                costs=mine, **kw))
        except Exception as e:  # noqa: BLE001 — report, go on
            out.append(_error(arch, shape_name, multi_pod, out_dir, e))
    return out


def _line(tag: str, r: dict) -> str:
    rt = r["roofline"]
    return (f"OK   {tag}: count={r['count_s']}s "
            f"peak={r['memory']['peak_bytes'] / 2**30:.2f}GiB/dev "
            f"bottleneck={rt['bottleneck']} "
            f"(c={rt['compute_s']:.2e}s m={rt['memory_s']:.2e}s "
            f"coll={rt['collective_s']:.2e}s)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--kv-dtype", default="bfloat16",
                    choices=["bfloat16", "float8_e5m2"])
    ap.add_argument("--tag", default="",
                    help="suffix for the artifact filename (perf iters)")
    ap.add_argument("--out", default="artifacts/torch_dryrun")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (a quick check)")
    args = ap.parse_args()
    out = pathlib.Path(args.out)

    from ..configs import ARCH_IDS, shape_cells

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            for sc in shape_cells(arch):
                cells.append((arch, sc.name))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape))

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    kw = dict(remat=args.remat, fsdp=False if args.no_fsdp else None,
              opt_dtype=args.opt_dtype, kv_dtype=args.kv_dtype,
              tag=args.tag, reduced=args.reduced)
    failures = 0
    for multi in meshes:
        mesh_word = "multi" if multi else "single"
        for r in run_cells(cells, multi, out, **kw):
            if r["status"] == "ok":
                print(_line(f"{r['arch']} x {r['shape']} x {mesh_word}", r),
                      flush=True)
            else:
                failures += 1
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
