"""The port's continuous-batching engine, with a model-free adapter.

``repro_torch.engine`` is the port's own copy of the reference engine
(queue, metrics, scheduler).  A fake adapter whose logits name a token
makes every decision of the engine observable without a model.
"""
import numpy as np
import pytest
import torch

from repro_torch.engine import (
    REJECT_BACKLOG_FULL,
    REJECT_DEADLINE_EXPIRED,
    STAGES,
    AdmissionQueue,
    Engine,
    EngineConfig,
    EngineRequest,
    greedy_sampler,
)
from repro_torch.engine.scheduler import _reset_state_slot

VOCAB = 16


class CountingAdapter:
    """Slot ``i`` at clock ``p`` samples token ``(i + p + 1) % VOCAB``."""

    def __init__(self):
        self.calls = []

    def init_state(self, batch_size, max_seq):
        return {"pos": torch.zeros((batch_size,), dtype=torch.int32)}

    def reset_slot(self, state, i):
        _reset_state_slot(state, i)

    def step(self, state, tokens, active):
        self.calls.append(list(active))
        logits = np.zeros((len(active), VOCAB), np.float32)
        for j, i in enumerate(active):
            logits[j, (i + int(state["pos"][i]) + 1) % VOCAB] = 1.0
        pos = state["pos"].clone()
        pos[list(active)] += 1
        return logits, dict(state, pos=pos)


def test_continuous_refills_and_static_drains():
    orders = {}
    for policy in ("continuous", "static"):
        ad = CountingAdapter()
        eng = Engine(ad, EngineConfig(batch_size=2, max_seq=32,
                                      policy=policy))
        for uid, new in enumerate((1, 4, 2)):
            eng.submit(EngineRequest(uid=uid, prompt=[1], max_new_tokens=new))
        stats = eng.run_until_drained()
        assert stats.completed == 3 and stats.tokens_generated == 7
        orders[policy] = (eng.completion_order, stats.steps, ad.calls)
    # continuous: uid 2 takes slot 0 as soon as uid 0 retires
    assert orders["continuous"][0] == [0, 2, 1]
    assert orders["continuous"][1] == 4
    # static: uid 2 waits until both slots drained
    assert orders["static"][0] == [0, 1, 2]
    assert orders["static"][1] == 6
    assert orders["static"][2][4:] == [[0], [0]]


def test_hooks_see_every_stage_in_order():
    seen = []
    eng = Engine(CountingAdapter(), EngineConfig(batch_size=1, max_seq=8),
                 hooks={s: [lambda e, stage, ctx: seen.append(stage)]
                        for s in STAGES})
    eng.submit(EngineRequest(uid=0, prompt=[3, 4], max_new_tokens=1))
    eng.run_until_drained()
    assert seen == list(STAGES) * 2
    with pytest.raises(KeyError, match="stage"):
        eng.add_hook("nope", lambda *a: None)


def test_backlog_deadline_and_eos():
    clock = [0.0]
    eng = Engine(CountingAdapter(),
                 EngineConfig(batch_size=1, max_seq=8, max_backlog=1,
                              eos_token=2), clock=lambda: clock[0])
    assert eng.submit(EngineRequest(uid=0, prompt=[1], max_new_tokens=5))
    full = eng.submit(EngineRequest(uid=1, prompt=[1], max_new_tokens=5))
    assert not full and full.reason == REJECT_BACKLOG_FULL
    late = eng.submit(EngineRequest(uid=2, prompt=[1], max_new_tokens=5,
                                    deadline=-1.0))
    assert late.reason == REJECT_DEADLINE_EXPIRED
    eng.run_until_drained()
    # slot 0 samples 1, 2 -> stops at the eos token
    snap = eng.metrics.snapshot()
    assert snap["requests"]["completed"] == 1
    assert snap["requests"]["rejected"] == 2
    assert snap["throughput"]["tokens_generated"] == 2


def test_max_seq_caps_generation_and_sampler_wants_one_row():
    eng = Engine(CountingAdapter(), EngineConfig(batch_size=1, max_seq=4))
    req = EngineRequest(uid=0, prompt=[1, 2], max_new_tokens=10)
    eng.submit(req)
    eng.run_until_drained()
    assert req.done and len(req.generated) == 2
    with pytest.raises(ValueError, match="one slot"):
        greedy_sampler(np.zeros((2, VOCAB)), req)


def test_queue_priority_then_fifo():
    q = AdmissionQueue(max_backlog=None, clock=lambda: 0.0)
    for uid, prio in ((0, 0), (1, 5), (2, 0), (3, 5)):
        q.submit(EngineRequest(uid=uid, prompt=[1], max_new_tokens=1,
                               priority=prio))
    assert [q.pop().uid for _ in range(4)] == [1, 3, 0, 2]
    assert q.pop() is None


def test_reset_state_slot_clears_packed_pages():
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.kvcache import PackedKVCache

    cfg = SMOLLM_135M.reduced(n_layers=1)
    kvc = PackedKVCache.create(cfg, bits=3, page_tokens=4, n_slots=2,
                               max_seq=8, device="cpu")
    k = torch.ones((2, cfg.n_kv_heads, cfg.head_dim))
    kvc.append(k, k, torch.zeros(2), torch.arange(2), layer=0)
    state = {"pos": torch.tensor([3, 5], dtype=torch.int32),
             "packed_kv": kvc}
    _reset_state_slot(state, 1)
    assert state["pos"].tolist() == [3, 0]
    assert not kvc.pages[:, 1].any() and kvc.pages[:, 0].any()
