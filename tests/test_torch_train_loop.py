"""The port's data pipeline, fault-tolerant train loop, train checkpoints
and train CLI against the reference (``src/repro/data``,
``src/repro/runtime/train_loop.py``, ``src/repro/launch/train.py``).

The train loop runs the tiny smollm of the reference's own
``tests/test_substrate.py::TestTrainLoop`` (2 layers, d_model 64, vocab
64) on the CPU, with the reference's four cases held on the port.  The
reference's ``Model.init`` weights go to the port through
``params_from_jax`` where the two are compared.

Tolerances: pipeline batches, restored checkpoint leaves and
``extra["pipeline"]`` equal bit for bit; the 12 ``run_training`` losses
(f32) within ``LOSS_RTOL`` = 1e-5 relative of the jitted reference's
(the 8-step parity of ``tests/test_torch_train.py`` measured 2e-7).
"""
import dataclasses
import shutil
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.checkpoint.checkpoint import CheckpointManager as RefMgr  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as RefPipeline  # noqa: E402
from repro.launch.steps import build_train_step as ref_build  # noqa: E402
from repro.launch.steps import init_train_state as ref_init  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.runtime.train_loop import TrainLoopConfig as RefLoopConfig  # noqa: E402
from repro.runtime.train_loop import run_training as ref_run  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    build_train_step,
    init_train_state,
)
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.pytree import flatten, leaf_paths, tree_map  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    TrainLoopConfig,
    device_batch,
    run_training,
)

LOSS_RTOL = 1e-5
TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab_size=64, head_dim=32)


# ----------------------------------------------------------------------
# the pipeline
# ----------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (128, 16, 8, 7), (64, 32, 4, 0), (49152, 33, 6, 3), (50, 8, 2, 11)])
def test_pipeline_batches_byte_identical(vocab, seq, batch, seed):
    ref = RefPipeline(vocab, seq, batch, seed=seed)
    port = SyntheticLMPipeline(vocab, seq, batch, seed=seed)
    for _ in range(3):
        want, got = ref.next_batch(), port.next_batch()
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].tobytes() == want[k].tobytes()
    assert port.state_dict() == ref.state_dict()
    for n_hosts in (1, 2):
        for host in range(n_hosts):
            lo, hi = port.host_slice(host, n_hosts)
            assert (lo, hi) == ref.host_slice(host, n_hosts)
            for k, v in ref.peek_batch(5, lo, hi).items():
                assert port.peek_batch(5, lo, hi)[k].tobytes() == v.tobytes()
                assert port.next_batch(lo, hi)[k].tobytes() == \
                    ref.next_batch(lo, hi)[k].tobytes()
    with pytest.raises(ValueError):
        port.host_slice(0, 5 if batch % 5 else 7)


def test_pipeline_resume_from_state_dict():
    port = SyntheticLMPipeline(97, 12, 4, seed=2)
    for _ in range(4):
        port.next_batch()
    state = port.state_dict()
    want = port.next_batch()
    ref = RefPipeline(97, 12, 4, seed=9)
    ref.load_state_dict(state)
    resumed = SyntheticLMPipeline(97, 12, 4, seed=9)
    resumed.load_state_dict(state)
    for got in (resumed.next_batch(), ref.next_batch()):
        for k in want:
            assert got[k].tobytes() == want[k].tobytes()


def test_device_batch():
    batch = SyntheticLMPipeline(64, 8, 2, seed=0).next_batch()
    out = device_batch(batch, "cpu")
    assert out["tokens"].dtype == torch.int64
    assert out["labels"].dtype == torch.int32
    for k in batch:
        assert np.array_equal(out[k].numpy(), batch[k])


# ----------------------------------------------------------------------
# the train loop: the reference's TestTrainLoop cases on the port
# ----------------------------------------------------------------------
def _tiny_setup(total_steps=12, ckpt_interval=4):
    cfg = port_configs.SMOLLM_135M.reduced(**TINY)
    step_fn = build_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=2,
                                                total_steps=total_steps))
    pipeline = SyntheticLMPipeline(64, 32, 4, seed=0)

    def init():
        return init_train_state(cfg, torch.Generator().manual_seed(0),
                                "cpu")

    loop_cfg = TrainLoopConfig(total_steps=total_steps,
                               ckpt_interval=ckpt_interval, max_restarts=3)
    return step_fn, init, pipeline, loop_cfg


def _cpu(batch):
    return device_batch(batch, "cpu")


def test_loss_decreases(tmp_path):
    step_fn, init, pipe, cfg = _tiny_setup(total_steps=25, ckpt_interval=10)
    rep = run_training(step_fn, init, pipe, str(tmp_path / "ck"), cfg,
                       to_batch=_cpu)
    assert rep.steps_run == 25 and rep.restarts == 0
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5])
    assert all(np.isfinite(rep.losses))


@pytest.mark.parametrize("attempt", range(5))
def test_failure_recovery_resumes_from_checkpoint(tmp_path, attempt):
    """Five times over, with no flake: recovery waits for the queued
    saves before it reads the latest step."""
    step_fn, init, pipe, cfg = _tiny_setup()
    crashed = {"done": False}

    def injector(step):
        if step == 6 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    rep = run_training(step_fn, init, pipe, str(tmp_path / "ck"), cfg,
                       fail_injector=injector, to_batch=_cpu)
    assert rep.restarts == 1
    # steps 4..5 replayed after restoring the step-4 checkpoint
    assert rep.steps_run == 12 + 2
    # the replayed steps give the first run's losses again
    assert rep.losses[6:8] == rep.losses[4:6]


def test_failure_recovery_waits_for_a_slow_save(tmp_path, monkeypatch):
    """A save still being written when the step fails is waited for: the
    loop restarts from step 4, not from step 0."""
    step_fn, init, pipe, cfg = _tiny_setup()
    write = CheckpointManager._write

    def slow_write(self, step, tree, extra):
        time.sleep(0.5)
        return write(self, step, tree, extra)

    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    crashed = {"done": False}

    def injector(step):
        if step == 5 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    rep = run_training(step_fn, init, pipe, str(tmp_path / "ck"), cfg,
                       fail_injector=injector, to_batch=_cpu)
    assert rep.restarts == 1 and rep.steps_run == 12 + 1


def test_straggler_hook_fires(tmp_path):
    """One step stalls for 10x the slowest step before it (at least 1 s,
    the reference test's stall), so it exceeds 3x the EWMA however
    loaded the machine is."""
    step_fn, init, pipe, cfg = _tiny_setup()
    seen = []
    slow = {"armed": True}
    took = [0.1]

    def wrapped(state, batch):
        if slow["armed"] and pipe.state.step == 9:
            slow["armed"] = False
            time.sleep(max(1.0, 10 * max(took)))
        t0 = time.monotonic()
        out = step_fn(state, batch)
        took.append(time.monotonic() - t0)
        return out

    rep = run_training(wrapped, init, pipe, str(tmp_path / "ck"), cfg,
                       on_straggler=lambda s, dt: seen.append((s, dt)),
                       to_batch=_cpu)
    assert rep.stragglers >= 1 and seen


def test_resume_across_runs(tmp_path):
    step_fn, init, pipe, cfg = _tiny_setup(total_steps=8, ckpt_interval=4)
    run_training(step_fn, init, pipe, str(tmp_path / "ck"), cfg,
                 to_batch=_cpu)
    # second invocation: nothing left to do, resumes from step 8
    pipe2 = SyntheticLMPipeline(64, 32, 4, seed=0)
    rep2 = run_training(step_fn, init, pipe2, str(tmp_path / "ck"), cfg,
                        to_batch=_cpu)
    assert rep2.resumed_from == 8
    assert rep2.steps_run == 0


def test_nonfinite_loss_is_skipped_and_state_kept(tmp_path):
    step_fn, init, pipe, cfg = _tiny_setup(total_steps=6, ckpt_interval=3)
    seen = []

    def poisoned(state, batch):
        seen.append(tree_map(torch.clone, state["params"]))
        if pipe.state.step == 3:
            new, m = step_fn(state, batch)
            return new, {**m, "loss": torch.tensor(float("nan"))}
        return step_fn(state, batch)

    rep = run_training(poisoned, init, pipe, str(tmp_path / "ck"), cfg,
                       to_batch=_cpu)
    assert rep.skipped_nonfinite == 1 and rep.steps_run == 5
    # the step after the skipped one started from the state before it
    assert all(torch.equal(a, b) for a, b in
               zip(flatten(seen[2]), flatten(seen[3])))


# ----------------------------------------------------------------------
# against the reference's loop
# ----------------------------------------------------------------------
def _ref_tiny(total_steps: int, dtype: str = "float32", seed: int = 0):
    """(reference config, port config, AdamW arguments, reference train
    state) of the tiny smollm in ``dtype``."""
    rcfg = dataclasses.replace(get_config("smollm-135m").reduced(**TINY),
                               dtype=dtype)
    pcfg = dataclasses.replace(port_configs.SMOLLM_135M.reduced(**TINY),
                               dtype=dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=total_steps)
    return rcfg, pcfg, kw, ref_init(rcfg, jax.random.PRNGKey(seed))


def _port_state_from(ref_state) -> dict:
    np_params = jax.tree.map(np.asarray, ref_state["params"])
    pp = params_from_jax(np_params, device="cpu")
    return {"params": pp, "opt": init_opt_state(pp)}


def test_run_training_losses_match_reference(tmp_path):
    rcfg, pcfg, kw, ref_state = _ref_tiny(12)
    loop = dict(total_steps=12, ckpt_interval=4)
    want = ref_run(jax.jit(ref_build(rcfg, RefAdamWConfig(**kw))),
                   lambda: ref_state, RefPipeline(64, 32, 4, seed=0),
                   str(tmp_path / "ref"), RefLoopConfig(**loop))
    got = run_training(build_train_step(pcfg, AdamWConfig(**kw)),
                       lambda: _port_state_from(ref_state),
                       SyntheticLMPipeline(64, 32, 4, seed=0),
                       str(tmp_path / "port"), TrainLoopConfig(**loop),
                       to_batch=_cpu)
    assert got.steps_run == want.steps_run == 12
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL,
                               atol=0)
    # both wrote the same steps, in one format
    assert CheckpointManager(tmp_path / "port").all_steps() == \
        RefMgr(tmp_path / "ref").all_steps() == [4, 8, 12]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_checkpoints_restore_across_packages(tmp_path, dtype):
    """A train state the port saved, restored by the reference, and the
    reverse: every leaf bit for bit, ``extra["pipeline"]`` equal."""
    _, pcfg, kw, ref_state = _ref_tiny(4, dtype, seed=1)
    state = _port_state_from(ref_state)
    pipe = SyntheticLMPipeline(64, 32, 4, seed=0)
    step = build_train_step(pcfg, AdamWConfig(**kw))
    for _ in range(2):                  # moments and step nonzero
        state, _ = step(state, _cpu(pipe.next_batch()))
    extra = {"pipeline": pipe.state_dict()}

    CheckpointManager(tmp_path / "a").save(2, state, extra=extra)
    got, got_extra = RefMgr(tmp_path / "a").restore(ref_state)
    assert got_extra == extra
    assert jax.tree.structure(got) == jax.tree.structure(ref_state)
    for path, x, y in zip(leaf_paths(state), flatten(state),
                          jax.tree.leaves(got)):
        assert np.array_equal(_bits(x), _bits(y)), path
        assert str(x.dtype).split(".")[-1] == np.asarray(y).dtype.name

    RefMgr(tmp_path / "b").save(2, got, extra=extra)
    back, back_extra = CheckpointManager(tmp_path / "b").restore(
        state, device="cpu")
    assert back_extra == extra
    for path, x, y in zip(leaf_paths(state), flatten(back), flatten(state)):
        assert x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y)), \
            path
    assert int(back["opt"]["step"]) == 2
    # the loop resumes from the reference's checkpoint
    shutil.rmtree(tmp_path / "a")
    loop = TrainLoopConfig(total_steps=3, ckpt_interval=1)
    rep = run_training(step, lambda: tree_map(torch.clone, state),
                       SyntheticLMPipeline(64, 32, 4, seed=0),
                       str(tmp_path / "b"), loop, to_batch=_cpu)
    assert rep.resumed_from == 2 and rep.steps_run == 1


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def test_cli_trains_on_the_cpu(tmp_path, capsys):
    train_cli.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                    "--steps", "20", "--batch", "4", "--seq-len", "64",
                    "--ckpt-dir", str(tmp_path / "ck"),
                    "--ckpt-interval", "10"])
    # a loaded machine may print "[straggler]" lines between these
    out = [line for line in capsys.readouterr().out.splitlines()
           if not line.startswith("[straggler]")]
    assert out[0] == "smollm-135m: 0.4M params (reduced) on cpu"
    assert out[1].startswith("steps=20 final_loss=")
    assert "restarts=0" in out[1] and out[1].endswith("resumed_from=None")
    assert out[2].startswith("loss curve: [")
    curve = [float(x) for x in out[2].split("[")[1].rstrip("]").split()]
    assert len(curve) >= 8 and curve[-1] < curve[0]
    assert CheckpointManager(tmp_path / "ck").all_steps() == [10, 20]


def test_cli_without_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "smollm-135m", "--reduced", "--steps", "1",
                        "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
