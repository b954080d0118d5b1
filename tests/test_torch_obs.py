"""The port's recorder (``repro_torch.obs``) and its spans in the served
path.

The recorder alone, under a CPU ``torch.profiler``, and through
``Engine`` + ``PackedAdapter(kv="packed")`` over a reduced smollm-135m
(2 layers) on the CPU: int3 served stream-direct, int4 through the
lane-packed views, the kernels' plain versions.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import SMOLLM_135M
from repro_torch.core.exec_plan import lower_exec
from repro_torch.core.iris import LayoutCache
from repro_torch.engine import Engine, EngineConfig, EngineRequest, \
    PackedAdapter
from repro_torch.models.params import init_params
from repro_torch.models.quantized import packed_decode_step
from repro_torch.quant import QuantSpec
from repro_torch.tree import pack_tree

MAX_SEQ = 32


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with recording off and nothing kept:
    the recorder is the process's."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture(scope="module")
def cfg():
    return SMOLLM_135M.reduced()


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def trees(cfg, params):
    return {bits: pack_tree(cfg, params, QuantSpec(bits=bits, group_size=32),
                            cache=LayoutCache(), device="cpu")
            for bits in (3, 4)}


def _requests(cfg, seed):
    rng = np.random.default_rng(seed)
    return [EngineRequest(uid=i, prompt=rng.integers(
        1, cfg.vocab_size, int(rng.integers(2, 5))).tolist(),
        max_new_tokens=3) for i in range(3)]


def _engine(cfg, tree, bits):
    return Engine(PackedAdapter(cfg, tree, kv="packed", kv_bits=bits),
                  EngineConfig(batch_size=2, max_seq=MAX_SEQ))


# -- the recorder -------------------------------------------------------
def test_off_records_nothing_and_returns_one_object():
    a = obs.span("model_step", rows=4)
    with a:
        b = obs.span("logits_copy")
        with b:
            obs.count("logits_copy_bytes", 10)
    assert a is b is obs.span("kv_append")
    rec = obs.collect()
    assert rec.spans == [] and rec.counts == {} and rec.dropped == 0


def test_on_nests_parents_and_adds_counts():
    obs.enable()
    with obs.span("engine.decode", step=7):
        with obs.span("model_step", rows=2):
            with obs.span("logits_copy"):
                obs.count("logits_copy_bytes", 40)
            obs.count("logits_copy_bytes", 2)
        with obs.span("engine.retire", step=7):
            pass
    with obs.span("lower_exec"):
        pass
    obs.count("other", 1)
    rec = obs.collect()
    assert [s.name for s in rec.spans] == [
        "engine.decode", "model_step", "logits_copy", "engine.retire",
        "lower_exec"]
    dec, step, copy, retire, top = rec.spans
    assert dec.parent is None and top.parent is None
    assert step.parent is dec and copy.parent is step and retire.parent is dec
    assert copy.path == "engine.decode/model_step/logits_copy"
    assert dec.attrs == {"step": 7} and step.attrs == {"rows": 2}
    assert rec.counts == {"logits_copy_bytes": 42, "other": 1}
    for s in rec.spans:
        assert s.dur_ns >= 0
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
    obs.disable()
    with obs.span("model_step"):
        obs.count("logits_copy_bytes", 1)
    assert len(obs.collect().spans) == 5
    assert obs.collect().counts["logits_copy_bytes"] == 42
    obs.reset()
    assert obs.collect().spans == [] and obs.collect().counts == {}


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(obs, "MAX_SPANS", 3)
    obs.enable()
    with obs.span("outer"):
        for _ in range(4):
            with obs.span("inner"):
                with obs.span("leaf"):
                    pass
    rec = obs.collect()
    assert [s.name for s in rec.spans] == ["outer", "inner", "leaf"]
    assert rec.dropped == 6
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)
    with obs.span("after"):              # nothing left open by the drops
        pass
    assert obs.collect().spans[1].parent is rec.spans[0]


def test_profiler_sees_spans_as_user_annotations():
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("model_step"):
            with obs.span("kv_append", layer=0):
                torch.ones(8).add_(1)
            with obs.span("logits_copy"):
                pass
    events = prof.profiler.kineto_results.events()
    marks = {e.name(): e for e in events if e.name().startswith("repro.")}
    assert set(marks) == {"repro.model_step", "repro.kv_append",
                          "repro.logits_copy"}
    assert all(e.is_user_annotation() for e in marks.values())
    outer = marks["repro.model_step"]
    for name in ("repro.kv_append", "repro.logits_copy"):
        assert outer.start_ns() <= marks[name].start_ns() \
            <= marks[name].end_ns() <= outer.end_ns()
    inner = marks["repro.kv_append"]
    ops = [e for e in events if e.name() == "aten::add_"]
    assert ops and all(inner.start_ns() <= e.start_ns() <= inner.end_ns()
                       for e in ops)
    assert [s.path for s in obs.collect().spans] == [
        "model_step", "model_step/kv_append", "model_step/logits_copy"]
    # off, a profiler sees none of them
    obs.disable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("model_step"):
            torch.ones(8).add_(1)
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("repro.")]


# -- set-up -------------------------------------------------------------
def test_pack_tree_spans_each_lowering(cfg, params):
    obs.enable()
    pack_tree(cfg, params, QuantSpec(bits=3, group_size=32),
              cache=LayoutCache(), device="cpu")
    rec = obs.collect()
    assert rec.spans and rec.dropped == 0
    assert all(s.name == "lower_exec" and s.parent is None and s.dur_ns > 0
               for s in rec.spans)


def test_lower_exec_spans_a_lowering_and_not_a_memo_hit(cfg, params):
    lay = pack_tree(cfg, params, QuantSpec(bits=4, group_size=32),
                    cache=LayoutCache(), device="cpu")._layout
    keys = list(lay._exec_cache)
    assert keys
    obs.enable()
    for key in keys:
        assert lower_exec(lay, key) is lay._exec_cache[key]
    assert obs.collect().spans == []
    lay._exec_cache.clear()
    for key in keys:
        lower_exec(lay, key)
    assert [s.name for s in obs.collect().spans] == ["lower_exec"] * len(keys)


# -- the served path ------------------------------------------------------
@pytest.mark.parametrize("bits,kind", [(3, "matmul.stream"),
                                       (4, "matmul.packed")])
def test_engine_steps_are_spanned_and_count_the_logits_copy(cfg, trees,
                                                            bits, kind):
    eng = _engine(cfg, trees[bits], bits)
    for r in _requests(cfg, bits):
        eng.submit(r)
    obs.enable()
    n_steps, copied = 0, 0
    while eng.has_work():
        ctx = eng.step()
        got = obs.collect().counts.get("logits_copy_bytes", 0) - copied
        assert got == len(ctx["active"]) * cfg.vocab_size * 4, n_steps
        copied += got
        n_steps += 1
    rec = obs.collect()
    assert rec.dropped == 0
    by_step: dict[int, list] = {}
    for s in rec.spans:
        if s.parent is None:
            assert s.name.startswith("engine.")
            by_step.setdefault(s.attrs["step"], []).append(s.name)
    assert list(by_step) == list(range(n_steps))
    for names in by_step.values():
        assert names == ["engine.admit", "engine.prefill", "engine.decode",
                         "engine.retire"]
    steps = [s for s in rec.spans if s.name == "model_step"]
    assert len(steps) == n_steps
    for st in steps:
        assert st.parent.name == "engine.decode"
        kids = [s.name for s in rec.spans if s.parent is st]
        assert kids[-2:] == ["logits", "logits_copy"]
        assert 1 <= st.attrs["rows"] <= 2
    paths: dict[str, int] = {}
    for s in rec.spans:
        paths[s.path] = paths.get(s.path, 0) + 1
    under = "engine.decode/model_step/"
    assert paths == {
        "engine.admit": n_steps, "engine.prefill": n_steps,
        "engine.decode": n_steps, "engine.retire": n_steps,
        "engine.decode/model_step": n_steps,
        under + "logits_copy": n_steps,
        under + "logits": n_steps,
        under + "kv_append": n_steps * cfg.n_layers,
        under + "attention": n_steps * cfg.n_layers,
        under + kind: n_steps * cfg.n_layers * 7}
    mms = [s.attrs for s in rec.spans if s.name == kind][:7]
    assert [(a["w"], a["layer"]) for a in mms] == [
        (w, 0) for w in ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                         "mlp/w_gate", "mlp/w_up", "mlp/w_down")]


@pytest.mark.parametrize("bits", [3, 4])
def test_spans_change_no_logit_and_no_token(cfg, trees, bits):
    tree = trees[bits]

    def logits_of():
        state = PackedAdapter(cfg, tree, kv="packed",
                              kv_bits=bits).init_state(2, MAX_SEQ)
        out = []
        for tok in ([5, 9], [7, 3], [11, 2]):
            logits, state = packed_decode_step(cfg, tree, state,
                                               torch.tensor(tok),
                                               kv="packed")
            out.append(logits)
        return torch.stack(out)

    def tokens_of():
        eng = _engine(cfg, tree, bits)
        reqs = _requests(cfg, 10 + bits)
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.generated for r in reqs]

    off = logits_of(), tokens_of()
    obs.enable()
    on = logits_of(), tokens_of()
    assert obs.collect().spans
    assert torch.equal(off[0].view(torch.int16), on[0].view(torch.int16))
    assert off[1] == on[1]
