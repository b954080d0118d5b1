"""The multi-rank checks of ``test_torch_distributed.py``, in one group.

Run as ``python tests/_torch_dist_worker.py WORKDIR``: forks 8 ranks of
a gloo process group (``init_method="file://WORKDIR/store"``, one CPU
thread each) that run every check once and write what the tests read:
``WORKDIR/rank{r}.json`` and ``WORKDIR/shards{r}.npz`` (each rank's
local shards), plus the files named below.  Imports the port only; the
reference's side comes in ``WORKDIR`` (``pipe_in.npz``,
``ref_ckpt/``, ``port_ckpt/``, ``packed_ckpt/``).
"""
import contextlib
import copy
import json
import os
import pathlib
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=64, head_dim=16, dtype="float32")
#: the sharded train steps: (name, arch, reduced config) — GQA, MHA with
#: LayerNorm and biases, and MoE with its experts over 'model'
TRAIN_CASES = (("gqa", "smollm-135m", SMALL),
               ("mha", "stablelm-3b", dict(SMALL, n_kv_heads=4)),
               ("moe", "moonshot-v1-16b-a3b", SMALL),
               ("hybrid", "jamba-1.5-large-398b", dict(SMALL, n_layers=8)))


def _np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _seeded_params(cfg, seed: int):
    """The port's params of ``cfg``, every leaf redrawn from numpy."""
    from repro_torch.models.model import Model
    from repro_torch.pytree import flatten, unflatten

    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(seed)
    leaves = [torch.from_numpy(rng.standard_normal(tuple(p.shape))
                               .astype(np.float32)).to(p.dtype)
              for p in flatten(params)]
    return unflatten(params, leaves)


def chunk_order(rank, out, shards):
    """Local shards of placed trees, for the chunk-order tests."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import (
        batch_sharding,
        decode_state_shardings,
        param_shardings,
        place,
    )
    from repro_torch.models.model import Model
    from repro_torch.pytree import flatten, leaf_paths

    cfg = get_config("smollm-135m").reduced()
    params = _seeded_params(cfg, 1)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32))}
    state = Model(cfg).init_decode_state(8, max_seq=16, device="cpu")
    state = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                 .astype(np.float32)).to(v.dtype)
             for k, v in state.items()}
    trees = {"params": params, "batch": batch, "state": state}
    if rank == 0:
        np.savez(out / "full.npz", **{
            f"{n}/{p}": _np(x) for n, t in trees.items()
            for p, x in zip(leaf_paths(t), flatten(t))})
    for mname, shape, axes in (("m24", (2, 4), ("data", "model")),
                               ("m222", (2, 2, 2),
                                ("pod", "data", "model"))):
        mesh = make_debug_mesh(shape, axes, device_type="cpu")
        rules = {"params": param_shardings(params, mesh, fsdp=True),
                 "batch": batch_sharding(batch, mesh),
                 "state": decode_state_shardings(state, mesh)}
        for n, t in trees.items():
            placed = place(t, rules[n])
            for p, x in zip(leaf_paths(t), flatten(placed)):
                shards[f"{mname}/{n}/{p}"] = _np(x.to_local())


def elastic(rank, out, res):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import (
        NamedSharding,
        P,
        opt_state_shardings,
        param_shardings,
        place,
    )
    from repro_torch.launch.steps import init_train_state
    from repro_torch.runtime.elastic import reshard_live, validate_resharding

    mesh8 = make_debug_mesh((2, 4), ("data", "model"), device_type="cpu")
    mesh4 = make_debug_mesh((1, 4), ("data", "model"), device_type="cpu")
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones((4,), dtype=torch.bfloat16)}
    placed = place(tree, {"w": NamedSharding(mesh8, P("data", "model")),
                          "b": NamedSharding(mesh8, P())})
    moved = reshard_live(placed, {"w": NamedSharding(mesh4,
                                                     P("data", "model")),
                                  "b": NamedSharding(mesh4, P())})
    validate_resharding(placed, moved)
    res["reshard_w_local"] = list(moved["w"].to_local().shape)
    res["reshard_mesh_size"] = moved["w"].device_mesh.size()
    # a whole train state, (2, 4) -> (1, 4)
    cfg = get_config("smollm-135m").reduced(**SMALL)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")

    def rules(mesh):
        ps = param_shardings(state["params"], mesh, fsdp=True)
        return {"params": ps,
                "opt": opt_state_shardings(state["opt"], ps, mesh)}
    placed = place(state, rules(mesh8))
    t0 = time.perf_counter()
    moved = reshard_live(placed, rules(mesh4))
    res["reshard_state_s"] = time.perf_counter() - t0
    validate_resharding(placed, moved)
    validate_resharding(state, moved)
    res["reshard_ok"] = True


def restore(rank, out, res):
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import (
        NamedSharding,
        P,
        packed_tree_shardings,
        place,
    )

    mesh = make_debug_mesh((2, 2), ("data", "model"), device_type="cpu")
    for name in ("port_ckpt", "ref_ckpt"):
        mgr = CheckpointManager(out / name)
        like = {"w": torch.empty((8, 4), dtype=torch.bfloat16)}
        tree, _ = mgr.restore(like, shardings={
            "w": NamedSharding(mesh, P("data", "model"))})
        if mesh.get_coordinate() is not None:
            res[f"{name}_local"] = list(tree["w"].to_local().shape)
            np.save(out / f"{name}_r{rank}.npy",
                    _np(tree["w"].full_tensor()))
    # a packed tree placed on the (2, 4) mesh saves byte-equal
    pt, _ = CheckpointManager(out / "packed_ckpt").restore_packed(
        device="cpu")
    mesh8 = make_debug_mesh((2, 4), ("data", "model"), device_type="cpu")
    sh = packed_tree_shardings(pt, mesh8)
    res["packed_specs"] = {k: list(v.spec) for k, v in sh.packed.items()}
    placed = place(pt, sh)
    CheckpointManager(out / f"packed_placed_r{rank}").save_packed(5, placed)


def pipeline(rank, out, res):
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime.pipeline_par import (
        PipelineConfig,
        pipeline_forward,
    )

    inp = np.load(out / "pipe_in.npz")
    mesh = make_debug_mesh((4,), ("stage",), device_type="cpu")
    if mesh.get_coordinate() is None:
        return
    cfg = PipelineConfig(n_stages=4, n_microbatches=6)
    ws = torch.from_numpy(inp["ws"])
    x = torch.from_numpy(inp["x"])
    y = pipeline_forward(lambda w, a: torch.tanh(a @ w), mesh, cfg, ws, x)
    np.save(out / f"pipe_out_r{rank}.npy", y.numpy())


def sharded_steps(rank, out, res):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import (
        batch_sharding,
        decode_state_shardings,
        opt_state_shardings,
        param_shardings,
        place,
    )
    from repro_torch.launch.steps import (
        build_serve_step,
        build_train_step,
        init_train_state,
    )
    from repro_torch.models.model import Model
    from repro_torch.kernels import linear_scan
    from repro_torch.models import mamba, transformer
    from repro_torch.models.shard_utils import local, use_mesh
    from repro_torch.pytree import flatten

    mesh = make_debug_mesh((2, 4), ("data", "model"), device_type="cpu")
    rng = np.random.default_rng(3)
    carry: list = []
    scans: dict = {}

    def spies() -> contextlib.ExitStack:
        """Spies on the period carry's sequence-parallel boundary (the
        shape and placements of what each call hands back) and on the
        Mamba scan (its autograd Function's forward and backward, and
        any call of the plain version from the Mamba layer in its
        place), each counting from zero."""
        carry.clear()
        scans.update(forward=0, backward=0, plain=0)
        real_shard = transformer.maybe_shard

        def spy(x, *spec):
            y = real_shard(x, *spec)
            if spec[1:] == ("model", None):
                carry.append((list(y.shape),
                              [repr(p) for p in y.placements]))
            return y

        def counted(key, fn):
            def wrapped(*args, **kw):
                scans[key] += 1
                return fn(*args, **kw)
            return wrapped

        fn = linear_scan._SSDScan
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(transformer, "maybe_shard",
                                              spy))
        for key in ("forward", "backward"):
            stack.enter_context(mock.patch.object(
                fn, key, staticmethod(counted(key, getattr(fn, key)))))
        stack.enter_context(mock.patch.object(
            mamba, "ssd_scan_plain", counted("plain", mamba.ssd_scan_plain)))
        return stack

    t0 = time.perf_counter()
    for name, arch, kw in TRAIN_CASES:
        t1 = time.perf_counter()
        cfg = get_config(arch).reduced(**kw)
        state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                                .astype(np.int32))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        step = build_train_step(cfg)
        ref_losses, s = [], state
        for _ in range(2):
            s, m = step(s, batch)
            ref_losses.append(float(m["loss"]))
        with use_mesh(mesh):
            ps = param_shardings(state["params"], mesh, fsdp=True)
            rules = {"params": ps,
                     "opt": opt_state_shardings(state["opt"], ps, mesh)}
            s = place(state, rules)
            b = place(batch, batch_sharding(batch, mesh))
            losses = []
            with spies():
                for _ in range(2):
                    s, m = step(s, b)
                    losses.append(float(local(m["loss"])))
        want = place(state, rules)
        res[f"train_{name}"] = {
            "losses": losses, "ref_losses": ref_losses,
            "placements": sorted({str(x.placements)
                                  for x in flatten(s["params"])}),
            "placements_kept": all(
                x.placements == y.placements
                for x, y in zip(flatten(s), flatten(want))),
            "carry": carry[:], "scans": dict(scans),
            "s": time.perf_counter() - t1}
    res["train_s"] = time.perf_counter() - t0
    # jamba: the serve step on the same mesh
    jcfg = get_config("jamba-1.5-large-398b").reduced(dtype="float32")
    model = Model(jcfg, remat="none")
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    st = model.init_decode_state(4, max_seq=32, device="cpu")
    toks = torch.from_numpy(rng.integers(0, jcfg.vocab_size, (4,))
                            .astype(np.int32))
    serve = build_serve_step(jcfg)
    ref_logits = []
    rs = copy.deepcopy(st)
    for _ in range(2):
        lg, rs = serve(params, rs, toks)
        ref_logits.append(lg)
    t0 = time.perf_counter()
    with use_mesh(mesh):
        dp = place(params, param_shardings(params, mesh, fsdp=False))
        ds = place(st, decode_state_shardings(st, mesh))
        errs = []
        for i in range(2):
            lg, ds = serve(dp, ds, toks)
            errs.append(float((local(lg) - ref_logits[i]).abs().max()))
    res["serve_s"] = time.perf_counter() - t0
    res["serve_err"] = errs
    res["serve_finite"] = bool(torch.isfinite(local(lg)).all())
    res["serve_shape"] = list(local(lg).shape)


def work(rank: int, out: str) -> None:
    out = pathlib.Path(out)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=WORLD)
    res: dict = {"rank": rank}
    shards: dict = {}
    try:
        for name, fn in (("chunk_order", lambda: chunk_order(rank, out,
                                                             shards)),
                         ("elastic", lambda: elastic(rank, out, res)),
                         ("restore", lambda: restore(rank, out, res)),
                         ("pipeline", lambda: pipeline(rank, out, res)),
                         ("steps", lambda: sharded_steps(rank, out, res))):
            t0 = time.perf_counter()
            fn()
            res[f"{name}_wall_s"] = time.perf_counter() - t0
            dist.barrier()
        res["ok"] = True
    except Exception:
        # written for the tests to show, then raised: the spawner ends
        # the other ranks rather than leave them in a collective
        res["ok"] = False
        res["error"] = traceback.format_exc()
        raise
    finally:
        np.savez(out / f"shards{rank}.npz", **shards)
        (out / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


if __name__ == "__main__":
    workdir = sys.argv[1]
    os.environ.setdefault("TMPDIR", tempfile.mkdtemp(dir=workdir))
    # the ranks fork from this process with the heavy modules imported
    # once, rather than each importing them anew
    import torch.distributed.tensor  # noqa: F401
    from repro_torch.launch import sharding, steps  # noqa: F401
    from repro_torch.models import model  # noqa: F401

    mp.start_processes(work, args=(workdir,), nprocs=WORLD, join=True,
                       start_method="fork")
