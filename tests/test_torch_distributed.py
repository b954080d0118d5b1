"""The distributed substrate of the port against the reference.

* Rules: the port's placements (``repro_torch.launch.sharding``) equal
  the reference's ``PartitionSpec``s leaf by leaf, for the ten configs at
  full size on abstract (16, 16), (2, 16, 16) and (2, 4) meshes — params
  with FSDP on and off, the AdamW state, the decode state with
  ``shard_seq`` both ways, batches, and reduced int3 / int4
  ``PackedTree``s.  The reference's side runs in this process on
  ``jax.sharding.AbstractMesh``; the per-card argument bytes equal the
  sum of its ``NamedSharding.shard_shape`` bytes.
* ``ModelConfig.with_tp``, ``maybe_shard`` / ``use_mesh`` and
  ``schedule_table``.
* Multi-rank: every check runs in one spawned gloo group of 8 ranks
  (``tests/_torch_dist_worker.py``, one thread a rank, its files under
  ``tmp_path``); the reference's device index maps and its
  ``pipeline_forward`` come from one subprocess with 8 forced host
  devices.  Each rank's local shards equal the reference's shards on the
  same device index, on a (2, 4) mesh and a (2, 2, 2) mesh with a
  ``('pod', 'data')`` entry; ``reshard_live`` / ``validate_resharding``,
  ``restore(shardings=)`` (a checkpoint the reference wrote too) and
  ``save_packed`` of a placed tree are bit-equal; ``pipeline_forward``
  is within 1e-5 of the reference's; the sharded train steps of a
  reduced smollm (GQA), stablelm (MHA), moonshot (MoE) and jamba (one
  hybrid period, its Mamba scans through ``ssd_scan``'s autograd
  Function) (f32, two steps) are within ``TRAIN_RTOL`` of the
  single-process steps, their period carry sequence-parallel (S sharded
  over 'model'), and the jamba serve step within ``SERVE_ATOL``.  The
  group runs once per pytest run, before the reference's subprocess and
  not beside it.

No test here initialises a process group, sets an environment variable
or leaves a mesh active in the pytest process.
"""
import functools
import json
import math
import os
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import sharding as ref_sh
from repro.launch import specs as ref_specs
from repro_torch import configs as pc
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as ps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.pytree import flatten, leaf_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
#: the sharded train step's loss against the single-process step: f32,
#: other summation orders (the tensor-parallel partial sums)
TRAIN_RTOL = 1e-5
#: the jamba serve step's f32 logits against the single-process step
SERVE_ATOL = 1e-4
PIPE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _nothing_left_behind():
    yield
    from repro_torch.models.shard_utils import active_mesh

    assert not torch.distributed.is_initialized()
    assert active_mesh() is None


def _meshes(name):
    shape, axes = MESHES[name]
    return RefAbstractMesh(shape, axes), AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return ref_specs.abstract_train_state(ref_get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    return ps.abstract_train_state(pc.get_config(arch))


def _ref_pairs(tree):
    """(path, NamedSharding) of a reference sharding tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefNamedSharding))
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), s) for path, s in flat]


def _assert_same(ref_tree, port_tree, ref_values, port_values):
    """Leaf by leaf: equal paths and specs; equal per-card bytes."""
    ref = _ref_pairs(ref_tree)
    port = list(zip(leaf_paths(port_tree), flatten(port_tree)))
    assert [p for p, _ in ref] == [p for p, _ in port]
    for (path, r), (_, p) in zip(ref, port):
        assert isinstance(p.spec, sh.PartitionSpec)
        assert tuple(r.spec) == tuple(p.spec), path
    ref_bytes = sum(math.prod(s.shard_shape(v.shape)) * v.dtype.itemsize
                    for (_, s), v in zip(ref, jax.tree.leaves(ref_values)))
    assert sh.argument_bytes(port_values, port_tree) == ref_bytes


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", pc.ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, fsdp):
    rmesh, pmesh = _meshes(mesh)
    rp, pp = _ref_state(arch)["params"], _port_state(arch)["params"]
    _assert_same(ref_sh.param_shardings(rp, rmesh, fsdp=fsdp),
                 sh.param_shardings(pp, pmesh, fsdp=fsdp), rp, pp)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", pc.ARCH_IDS)
def test_state_specs_match_reference(arch, mesh):
    """AdamW state, both decode states, and the train / decode batches."""
    rmesh, pmesh = _meshes(mesh)
    rs, pst = _ref_state(arch), _port_state(arch)
    _assert_same(ref_sh.opt_state_shardings(rs["opt"], None, rmesh),
                 sh.opt_state_shardings(pst["opt"], None, pmesh),
                 rs["opt"], pst["opt"])
    rcfg, pcfg = ref_get_config(arch), pc.get_config(arch)
    shape = REF_SHAPES["decode_32k"]
    rdec = ref_specs.decode_state_specs(rcfg, shape)
    pdec = ps.decode_state_specs(pcfg, pc.SHAPES["decode_32k"])
    for shard_seq in (False, True):
        _assert_same(
            ref_sh.decode_state_shardings(rdec["state"], rmesh,
                                          shard_seq=shard_seq),
            sh.decode_state_shardings(pdec["state"], pmesh,
                                      shard_seq=shard_seq),
            rdec["state"], pdec["state"])
    if "cross_kv" in rdec:
        _assert_same(
            ref_sh.decode_state_shardings({"cross_kv": rdec["cross_kv"]},
                                          rmesh),
            sh.decode_state_shardings({"cross_kv": pdec["cross_kv"]},
                                      pmesh),
            {"cross_kv": rdec["cross_kv"]}, {"cross_kv": pdec["cross_kv"]})
    for name in ("train_4k", "decode_32k"):
        rb = ref_specs.train_batch_specs(rcfg, REF_SHAPES[name])
        pb = ps.train_batch_specs(pcfg, pc.SHAPES[name])
        _assert_same(ref_sh.batch_sharding(rb, rmesh),
                     sh.batch_sharding(pb, pmesh), rb, pb)


@functools.lru_cache(maxsize=None)
def _packed_trees(bits):
    """(reference tree, port tree) of reduced smollm, packed by each
    package from the port's seeded weights (their streams byte-equal)."""
    import jax.numpy as jnp
    from repro import api as ref_api
    from repro.core.iris import LayoutCache as RefCache
    from repro.quant import QuantSpec as RefSpec
    from repro_torch.core.iris import LayoutCache
    from repro_torch.models.params import init_params
    from repro_torch.pytree import tree_map
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

    cfg = pc.SMOLLM_135M.reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref_params = tree_map(lambda x: jnp.asarray(x.float().numpy()).astype(
        str(x.dtype).removeprefix("torch.")), params)
    rt = ref_api.pack_tree(ref_get_config("smollm-135m").reduced(),
                           ref_params, RefSpec(bits=bits, group_size=32),
                           cache=RefCache())
    pt = pack_tree(cfg, params, QuantSpec(bits=bits, group_size=32),
                   cache=LayoutCache(), device="cpu")
    assert np.array_equal(np.asarray(rt.streams), pt.streams.numpy())
    return rt, pt


@pytest.mark.parametrize("bits", [3, 4])
def test_packed_tree_specs_match_reference(bits):
    rt, pt = _packed_trees(bits)
    for mesh in MESHES:
        rmesh, pmesh = _meshes(mesh)
        rs = ref_sh.packed_tree_shardings(rt, rmesh)
        pts = sh.packed_tree_shardings(pt, pmesh)
        for key in rt.packed:
            assert tuple(rs.packed[key].spec) == tuple(pts.packed[key].spec)
            assert tuple(rs.scales[key].spec) == tuple(pts.scales[key].spec)
        assert tuple(rs.streams.spec) == tuple(pts.streams.spec)
        _assert_same(rs.other, pts.other, rt.other, pt.other)
        specs = sh.shardings_to_specs(pts)
        assert specs.manifest is pt.manifest
        assert tuple(specs.streams) == tuple(rs.streams.spec)


@pytest.mark.parametrize("arch", pc.ARCH_IDS)
def test_with_tp_matches_reference(arch):
    import dataclasses

    for tp in (1, 2, 4, 8, 16):
        r = dataclasses.asdict(ref_get_config(arch).with_tp(tp))
        p = dataclasses.asdict(pc.get_config(arch).with_tp(tp))
        assert p == r, tp


def test_maybe_shard_is_identity_without_a_mesh():
    from repro_torch.models.shard_utils import (
        active_mesh,
        dp_spec,
        gather_grad,
        local,
        local_rows,
        maybe_shard,
        rows_like,
        split_heads,
        unshard,
        use_mesh,
    )

    x = torch.randn(4, 6, 8)
    assert active_mesh() is None and dp_spec() == ("data",)
    assert maybe_shard(x, dp_spec(), None, "model") is x
    assert unshard(x, -1) is x and local(x) is x and gather_grad(x, 1) is x
    assert local_rows(x) is x and rows_like(x, x) is x
    assert torch.equal(split_heads(x, 4, 6, 2, 4), x.reshape(4, 6, 2, 4))
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    seen = []
    with pytest.raises(RuntimeError):
        with use_mesh(mesh):
            assert active_mesh() is mesh and dp_spec() == ("pod", "data")
            # an abstract mesh places nothing: the same object back
            assert maybe_shard(x, dp_spec(), None, "model") is x
            t = threading.Thread(target=lambda: seen.append(active_mesh()))
            t.start()
            t.join()
            raise RuntimeError("leave the block")
    assert seen == [None] and active_mesh() is None


def test_placements_follow_the_rules():
    """Spec -> DTensor placements: an entry's axes in mesh order, each
    mesh axis once, every sharded dim dividing evenly."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    got = sh.placements(sh.P(("pod", "data"), None, "model"), mesh, (8, 3, 4))
    assert got == (Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sh.placements(sh.P(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        sh.placements(sh.P("data", "data"), mesh)
    with pytest.raises(AssertionError):
        sh.placements(sh.P("model"), mesh, (3,))
    ns = sh.NamedSharding(mesh, sh.P(("pod", "data"), "model"))
    assert ns.shard_shape((8, 6)) == (2, 3)


def test_schedule_table_matches_reference():
    from repro.runtime.pipeline_par import PipelineConfig as RefPC
    from repro.runtime.pipeline_par import schedule_table as ref_table
    from repro_torch.runtime.pipeline_par import (
        PipelineConfig,
        schedule_table,
    )

    for s, m in ((4, 8), (4, 6), (1, 3), (3, 1)):
        cfg = PipelineConfig(n_stages=s, n_microbatches=m)
        assert schedule_table(cfg) == ref_table(RefPC(s, m))
        assert cfg.bubble_fraction == RefPC(s, m).bubble_fraction
    table = schedule_table(PipelineConfig(4, 8))
    assert len(table) == 11 and sum(r.count(None) for r in table) == 12


# ----------------------------------------------------------------------
# multi-rank: one spawned group
# ----------------------------------------------------------------------
_REF_SUB = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_debug_mesh
from repro.launch.sharding import (batch_sharding, decode_state_shardings,
                                   param_shardings)
from repro.launch.specs import abstract_params
from repro.models.model import Model
from repro.runtime.pipeline_par import PipelineConfig, pipeline_forward

out = sys.argv[1]
cfg = get_config("smollm-135m").reduced()
params = abstract_params(cfg)
batch = {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32)}
state = jax.eval_shape(lambda: Model(cfg).init_decode_state(8, max_seq=16))

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

maps = {}
for mname, shape, axes in (("m24", (2, 4), ("data", "model")),
                           ("m222", (2, 2, 2), ("pod", "data", "model"))):
    mesh = make_debug_mesh(shape, axes)
    rules = {"params": param_shardings(params, mesh, fsdp=True),
             "batch": batch_sharding(batch, mesh),
             "state": decode_state_shardings(state, mesh)}
    trees = {"params": params, "batch": batch, "state": state}
    for n in trees:
        leaves = jax.tree_util.tree_flatten_with_path(trees[n])[0]
        shs = jax.tree.leaves(rules[n])
        for (path, leaf), s in zip(leaves, shs):
            idx = s.devices_indices_map(tuple(leaf.shape))
            maps[f"{mname}/{n}/{key(path)}"] = {
                str(d.id): [[sl.start or 0, leaf.shape[i] if sl.stop is None
                             else sl.stop] for i, sl in enumerate(ix)]
                for d, ix in idx.items()}
json.dump(maps, open(out + "/ref_maps.json", "w"))
inp = np.load(out + "/pipe_in.npz")
y = pipeline_forward(lambda w, x: jnp.tanh(x @ w),
                     make_debug_mesh((4,), ("stage",)),
                     PipelineConfig(n_stages=4, n_microbatches=6),
                     jnp.asarray(inp["ws"]), jnp.asarray(inp["x"]))
np.save(out + "/ref_pipe.npy", np.asarray(y))
print("SUBPROCESS_OK")
"""


def _run_group(work: pathlib.Path) -> None:
    """The port's 8-rank group, then the reference's subprocess (one
    after the other, the reference's XLA on one thread), over ``work``."""
    import jax.numpy as jnp
    from repro.checkpoint.checkpoint import CheckpointManager as RefMgr
    from repro_torch.checkpoint.checkpoint import CheckpointManager

    rng = np.random.default_rng(0)
    np.savez(work / "pipe_in.npz",
             ws=(rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
             x=rng.standard_normal((6, 2, 16)).astype(np.float32))
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    RefMgr(work / "ref_ckpt").save(1, {"w": jnp.asarray(w, jnp.bfloat16)})
    CheckpointManager(work / "port_ckpt").save(
        1, {"w": torch.from_numpy(w).to(torch.bfloat16)})
    from repro_torch.core.iris import LayoutCache
    from repro_torch.models.params import init_params
    from repro_torch.quant import QuantSpec
    from repro_torch.tree import pack_tree

    cfg = pc.SMOLLM_135M.reduced()
    tree = pack_tree(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"),
                     QuantSpec(bits=4, group_size=32), cache=LayoutCache(),
                     device="cpu")
    CheckpointManager(work / "packed_ckpt").save_packed(5, tree)
    CheckpointManager(work / "packed_plain").save_packed(5, tree)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
         str(work)], capture_output=True, text=True, env=env, timeout=600)
    ref = subprocess.run(
        [sys.executable, "-c", _REF_SUB, str(work)], capture_output=True,
        text=True, timeout=600,
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                 "--xla_cpu_multi_thread_eigen=false "
                 "intra_op_parallelism_threads=1"))
    assert ref.returncode == 0 and "SUBPROCESS_OK" in ref.stdout, \
        ref.stderr[-3000:]
    for r in range(8):
        assert (work / f"rank{r}.json").exists(), port.stderr[-4000:]
    assert port.returncode == 0, port.stderr[-4000:]


@pytest.fixture(scope="module")
def group(tmp_path_factory, worker_id):
    """Runs the port's 8-rank group and the reference's subprocess once
    per test session, also when the cases that use it land on several
    xdist workers (the first takes a lock and runs it; the others read
    its files); returns (workdir, [rank results])."""
    import fcntl

    if worker_id == "master":
        work = tmp_path_factory.mktemp("dist")
        _run_group(work)
    else:
        work = tmp_path_factory.getbasetemp().parent / "torch_dist_group"
        with open(f"{work}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if (work / "failed").exists():
                pytest.fail((work / "failed").read_text())
            if not (work / "done").exists():
                work.mkdir()
                try:
                    _run_group(work)
                except BaseException as e:
                    (work / "failed").write_text(f"the group failed: {e}")
                    raise
                (work / "done").write_text("")
    results = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(8)]
    for res in results:
        assert res["ok"], res.get("error")
    return work, results


@pytest.mark.parametrize("mesh", ["m24", "m222"])
def test_local_shards_match_reference_devices(group, mesh):
    work, _ = group
    maps = json.loads((work / "ref_maps.json").read_text())
    full = np.load(work / "full.npz")
    n = 0
    for r in range(8):
        shards = np.load(work / f"shards{r}.npz")
        for key, by_dev in maps.items():
            if not key.startswith(mesh + "/"):
                continue
            name = key.split("/", 1)[1]
            want = full[name][tuple(slice(a, b) for a, b in by_dev[str(r)])]
            assert np.array_equal(shards[key], want), (r, key)
            n += 1
    assert n == 8 * len([k for k in maps if k.startswith(mesh + "/")])
    if mesh == "m222":
        # the batch dim is split over ('pod', 'data'), pod major
        assert any(len({tuple(v[0]) for v in by.values()}) == 4
                   for k, by in maps.items() if k.startswith("m222/batch"))


def test_reshard_live_and_validate(group):
    _, results = group
    for res in results:
        assert res["reshard_ok"]
    for res in results[:4]:
        assert res["reshard_w_local"] == [8, 2]
        assert res["reshard_mesh_size"] == 4
    # ranks outside the (1, 4) mesh hold nothing
    for res in results[4:]:
        assert res["reshard_w_local"] == [0]


def test_restore_onto_mesh_bit_equal(group):
    work, results = group
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4) \
        .to(torch.bfloat16).view(torch.int16).numpy()
    for r, res in enumerate(results[:4]):
        for name in ("port_ckpt", "ref_ckpt"):
            assert res[f"{name}_local"] == [4, 2]
            assert np.array_equal(np.load(work / f"{name}_r{r}.npy"), w)


def test_save_packed_of_a_placed_tree_is_byte_equal(group):
    work, results = group
    assert results[0]["packed_specs"]["attn/wq"][-1] == "model"
    plain = sorted((work / "packed_plain" / "step_00000005").iterdir())
    for r in range(8):
        d = work / f"packed_placed_r{r}" / "step_00000005"
        placed = sorted(d.iterdir())
        assert [p.name for p in placed] == [p.name for p in plain]
        for a, b in zip(plain, placed):
            assert a.read_bytes() == b.read_bytes(), (r, a.name)


def test_pipeline_forward_matches_reference(group):
    work, _ = group
    ref = np.load(work / "ref_pipe.npy")
    inp = np.load(work / "pipe_in.npz")
    plain = inp["x"]
    for s in range(4):
        plain = np.tanh(plain @ inp["ws"][s])
    for r in range(4):
        out = np.load(work / f"pipe_out_r{r}.npy")
        np.testing.assert_allclose(out, ref, rtol=PIPE_TOL, atol=PIPE_TOL)
        np.testing.assert_allclose(out, plain, rtol=PIPE_TOL, atol=PIPE_TOL)


@pytest.mark.parametrize("case", ["gqa", "mha", "moe", "hybrid"])
def test_sharded_train_step_matches_single_process(group, case):
    """Reduced smollm (GQA), stablelm (MHA, LayerNorm and biases),
    moonshot (MoE, experts over 'model') and jamba (one period of seven
    Mamba sublayers and an attention one, MoE every second), f32, on
    (2, 4) with FSDP: two placed steps' losses within ``TRAIN_RTOL`` of
    the single-process steps', and the new state placed as the old.
    jamba's Mamba scans run through ``ssd_scan``'s autograd Function,
    forward and backward, and never through the plain version in its
    place."""
    _, results = group
    for res in results:
        got = res[f"train_{case}"]
        np.testing.assert_allclose(got["losses"], got["ref_losses"],
                                   rtol=TRAIN_RTOL)
        assert got["placements_kept"]
        scans = got["scans"]
        if case == "hybrid":
            # 7 Mamba sublayers: forward and remat recompute, 2 steps
            assert scans["forward"] == 28 and scans["backward"] == 14
        else:
            assert scans["forward"] == scans["backward"] == 0
        assert scans["plain"] == 0
    assert any("Shard" in p and "Replicate" not in p
               for p in results[0][f"train_{case}"]["placements"])


@pytest.mark.parametrize("case", ["gqa", "mha", "moe", "hybrid"])
def test_period_carry_is_sequence_parallel(group, case):
    """``forward_stack``'s carry at both ends of every period (and in
    remat's recompute) comes back with S sharded over 'model' (the
    (2, 4) mesh's second dim) and the batch over 'data', as the
    reference's ``maybe_shard(x, dp_spec(), "model", None)`` places it:
    S = 16 divides the 'model' size 4."""
    _, results = group
    for res in results:
        carry = res[f"train_{case}"]["carry"]
        # both ends of each period's forward, in each of 2 steps (the
        # recompute adds the calls it reaches before it has every saved
        # tensor back)
        assert len(carry) >= 2 * 2 * (1 if case == "hybrid" else 2)
        for shape, placements in carry:
            assert shape[1] % 4 == 0
            assert placements == ["Shard(dim=0)", "Shard(dim=1)"], placements


def test_sharded_serve_step_matches_single_process(group):
    _, results = group
    for res in results:
        assert res["serve_finite"] and res["serve_shape"] == [4, 512]
        assert max(res["serve_err"]) <= SERVE_ATOL
