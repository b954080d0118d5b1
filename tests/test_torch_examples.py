"""The port's examples (``repro_torch.examples``) against the reference's
scripts under ``examples/``, on the CPU.

* quickstart: §1's lines (every strategy's C_max / L_max / B_eff and the
  render) and §2's packed buffer equal what ``repro.api`` gives for the
  same calls; the ``cuda`` backend's decode (its plain version here)
  equals the codes; the whole example runs (its loss drops).
* packed_serving at ``--bits 4 --new-tokens 2``: the reference's script
  runs in this process (its Pallas kernels in interpret mode) and the
  port's example runs on the reference's ``Model(cfg).init(PRNGKey(0))``
  parameters carried across; each request's tokens, the bytes-per-token
  lines, the layer stack's plan line, the restore line and the top-1
  agreement line are equal.
* train_lm: the recipe (both presets' configs, the AdamW and train-loop
  configs, the first pipeline batches) equals the reference's; a run of
  ``--steps 2 --seq-len 16 --batch 2`` fails the example's learning bar,
  as the reference's does, and a second run on the same directory has
  nothing to do.
"""
import dataclasses
import importlib.util
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """The examples' small models on one torch thread (restored after):
    under xdist the workers share the cores, and many threads over tiny
    ops make these runs several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_example(name: str):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text: str) -> list[str]:
    return text.splitlines()


def test_quickstart_sections_match_reference(capsys):
    from repro import api as ref_api
    from repro_torch.examples import quickstart

    pl = quickstart.strategies_section()
    codes = quickstart.roundtrip_section(pl, "cpu")
    got = _lines(capsys.readouterr().out)
    want = []
    for name in ref_api.strategies():
        m = ref_api.plan(ref_api.PAPER_EXAMPLE, name).metrics
        want.append(f"{name:12s} C_max={m.c_max:3d}  L_max={m.l_max:3d}  "
                    f"B_eff={m.efficiency:.1%}")
    rpl = ref_api.plan(ref_api.PAPER_EXAMPLE).validate()
    render = rpl.render().splitlines()
    assert got[1:1 + len(want)] == want
    assert got[len(want) + 3:len(want) + 3 + len(render)] == render
    rcodes = ref_api.random_codes(rpl.problem, seed=42)
    assert codes.keys() == rcodes.keys()
    for k in codes:
        assert np.array_equal(codes[k], rcodes[k])
    rbuf = rpl.pack(rcodes)
    assert np.array_equal(pl.pack(codes), rbuf)
    assert f"packed buffer: {rbuf.shape[0]} cycles x {rbuf.shape[1]} " \
        "bytes" in got
    assert got[-1] == "numpy == cuda == original data for all arrays  [OK]"


def test_quickstart_main_on_cpu(capsys):
    from repro_torch.examples import quickstart

    rep = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rep.steps_run == 60 and rep.restarts == 0
    assert sum(rep.losses[-5:]) < sum(rep.losses[:5])
    assert out.splitlines()[-1].endswith("over 60 steps  [OK]")


#: the lines of packed_serving that depend on the weights, the plan and
#: the restore, not on the package (the tree's summary names its device
#: and counts its bytes in the package's own way; the timing line differs)
SERVING_PREFIXES = ("weight stream per decode token:", "reduction vs bf16:",
                    "B_eff=", "request ", "restore bit-identical=",
                    "top-1 agreement packed vs dense:")


def test_packed_serving_matches_reference(capsys, monkeypatch):
    from repro.configs import get_config as ref_get_config
    from repro.models.model import Model as RefModel
    from repro_torch.examples import packed_serving
    from repro_torch.models.params import params_from_jax

    monkeypatch.setattr(sys, "argv", ["packed_serving.py", "--bits", "4",
                                      "--new-tokens", "2"])
    _reference_example("packed_serving").main()
    ref_out = capsys.readouterr().out
    rcfg = ref_get_config("smollm-135m").reduced(
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=512, head_dim=64)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(
        packed_serving.config())
    params = RefModel(rcfg, remat="none").init(jax.random.PRNGKey(0))
    res = packed_serving.run(
        bits=4, new_tokens=2, device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, params),
                               device="cpu"))
    got_out = capsys.readouterr().out

    def picked(text):
        return [ln for ln in _lines(text) if ln.startswith(SERVING_PREFIXES)]

    want = picked(ref_out)
    assert len(want) == 9
    assert picked(got_out) == want
    assert res["restore_same"] and res["agreement"] == 1.0
    assert [f"request {i}: {t}" for i, t in enumerate(res["tokens"])] \
        == want[3:7]


def _ref_recipe(steps, seq_len, batch, preset="small"):
    """The reference example's recipe, written as its ``main`` builds it."""
    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLMPipeline
    from repro.optim.adamw import AdamWConfig
    from repro.runtime.train_loop import TrainLoopConfig

    base = get_config("smollm-135m")
    cfg = base if preset == "full" else base.reduced(
        n_layers=6, d_model=384, n_heads=6, n_kv_heads=2, d_ff=1024,
        vocab_size=2048, head_dim=64, max_seq_len=seq_len)
    opt = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    pipe = SyntheticLMPipeline(cfg.vocab_size, seq_len, batch, seed=0)
    loop = TrainLoopConfig(total_steps=steps,
                           ckpt_interval=max(10, steps // 6),
                           log_interval=10)
    return cfg, opt, pipe, loop


@pytest.mark.parametrize("preset,steps,seq_len,batch",
                         [("small", 300, 128, 8), ("small", 2, 16, 2),
                          ("full", 30, 128, 8)])
def test_train_lm_recipe_matches_reference(preset, steps, seq_len, batch):
    from repro_torch.examples import train_lm

    rcfg, ropt, rpipe, rloop = _ref_recipe(steps, seq_len, batch, preset)
    cfg = train_lm.config(preset, seq_len)
    opt, pipe, loop = train_lm.recipe(cfg, steps, seq_len, batch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(opt) == dataclasses.asdict(ropt)
    assert dataclasses.asdict(loop) == dataclasses.asdict(rloop)
    for _ in range(2):
        a, b = pipe.next_batch(), rpipe.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert train_lm.DEFAULT_CKPT != "artifacts/train_lm_ckpt"


def test_train_lm_short_run_fails_the_bar_then_has_nothing_to_do(
        tmp_path, capsys, monkeypatch):
    from repro_torch.examples import train_lm

    argv = ["--steps", "2", "--seq-len", "16", "--batch", "2"]
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv, "--ckpt",
                                      str(tmp_path / "ref")])
    with pytest.raises(AssertionError, match="model failed to learn"):
        _reference_example("train_lm").main()
    port = [*argv, "--ckpt", str(tmp_path / "port"), "--device", "cpu"]
    capsys.readouterr()
    with pytest.raises(AssertionError, match="model failed to learn"):
        train_lm.main(port)
    first = capsys.readouterr().out
    assert "config: 6L d=384" in first and "resumed_from=None" in first
    rep = train_lm.main(port)
    out = capsys.readouterr().out
    assert rep.losses == [] and rep.resumed_from == 2
    assert "nothing to do (already trained to --steps" in out
