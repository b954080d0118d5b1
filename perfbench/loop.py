"""The closed loop: clients that send their next request when the last ends.

Each of ``clients`` clients keeps one request in the engine.  The loop
drives :meth:`Engine.step` and attaches to it only from outside: its
spans and token stamps come from the engine's stage hooks, and each
output token passes through its own greedy sampler.  A request that
retires in a step is answered at that step's end; its client sends the
next one at once, and the engine admits it at the next step.
"""
from __future__ import annotations

import time

import numpy as np

from .record import RequestLog, StepRecord


class ClosedLoop:
    def __init__(self, engine_factory, source, clients: int, *,
                 clock=time.perf_counter) -> None:
        """``engine_factory(sampler)`` builds the engine with this loop's
        sampler; ``source`` is a :class:`~perfbench.traffic.RequestSource`."""
        self.clock = clock
        self.source = source
        self.clients = int(clients)
        self.engine = engine_factory(self.sample)
        for stage in ("admit", "prefill", "decode", "retire"):
            self.engine.add_hook(stage, getattr(self, f"_on_{stage}"))
        self.logs: dict[int, RequestLog] = {}
        self.steps: list[StepRecord] = []
        self._produced: list[tuple[int, int]] = []
        self._rec: StepRecord | None = None
        self._uid = 0

    # -- requests ------------------------------------------------------
    def _send(self, client: int, first: bool = False) -> None:
        from repro_torch.engine import EngineRequest

        prompt, max_new = self.source.next(first=first)
        uid = self._uid
        self._uid += 1
        self.logs[uid] = RequestLog(uid=uid, client=client, prompt=prompt,
                                    max_new=max_new, sent=self.clock())
        adm = self.engine.submit(EngineRequest(uid=uid, prompt=prompt,
                                               max_new_tokens=max_new))
        if not adm:
            raise RuntimeError(f"request {uid} refused: {adm.reason}")

    def start(self) -> None:
        for c in range(self.clients):
            self._send(c, first=True)

    def prime(self) -> None:
        """One step of ``clients`` one-token requests that no client sent:
        the program builds what it builds on first use (tables, library
        loads) at the cell's M before any client waits on it.  Leaves no
        record."""
        from repro_torch.engine import EngineRequest

        for c in range(self.clients):
            uid = self._uid
            self._uid += 1
            self.logs[uid] = RequestLog(uid=uid, client=-1, prompt=[0],
                                        max_new=1, sent=self.clock())
            self.engine.submit(EngineRequest(uid=uid, prompt=[0],
                                             max_new_tokens=1))
        self.step()
        if self.engine.has_work():
            raise RuntimeError("the priming step left work behind")
        self.logs.clear()
        self.steps.clear()

    # -- the engine's side ---------------------------------------------
    def sample(self, logits_row, request) -> int:
        """Greedy: the argmax of the slot's logits row."""
        tok = int(np.asarray(logits_row).argmax())
        self._produced.append((request.uid, tok))
        return tok

    def _on_admit(self, engine, stage, ctx) -> None:
        self._rec.t_admit = self.clock()

    def _on_prefill(self, engine, stage, ctx) -> None:
        rec = self._rec
        rec.t_prefill = self.clock()
        active = ctx["active"]
        rec.rows = len(active)
        rec.kv_tokens = int(engine.slot_pos[active].sum()) + len(active)

    def _on_decode(self, engine, stage, ctx) -> None:
        self._rec.t_decode = self.clock()

    def _on_retire(self, engine, stage, ctx) -> None:
        now = self.clock()
        rec = self._rec
        rec.tokens = len(self._produced)
        for uid, tok in self._produced:
            log = self.logs[uid]
            log.tokens.append(tok)
            log.token_times.append(now)
        self._produced.clear()
        for _, uid in ctx.get("retired", ()):
            log = self.logs[uid]
            log.done = now
            if log.client >= 0:
                self._send(log.client)
        rec.t_end = self.clock()

    # -- driving -------------------------------------------------------
    def step(self) -> StepRecord:
        self._rec = StepRecord(t0=self.clock())
        self.engine.step()
        self.steps.append(self._rec)
        return self._rec

    def run_steps(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def run_for(self, seconds: float) -> tuple[float, float, list[StepRecord]]:
        """Steps until ``seconds`` have passed: ``(w0, w1, steps)``, the
        window from the end of the last step before it to the end of its
        last step."""
        w0 = self.steps[-1].t_end if self.steps else self.clock()
        first = len(self.steps)
        while True:
            rec = self.step()
            if rec.t_end - w0 >= seconds:
                return w0, rec.t_end, self.steps[first:]
