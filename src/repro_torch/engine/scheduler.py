"""Stage-decoupled continuous-batching scheduler over packed or dense weights.

Port of ``src/repro/engine/scheduler.py``: :class:`Engine`,
:class:`EngineConfig`, :func:`greedy_sampler`, :class:`DenseAdapter`
(``:131-166``) and :class:`PackedAdapter` (``kv="packed" | "dense"``,
``uploader=``), with a torch :func:`_reset_state_slot` in place of the
reference's ``.at[].set``.

The engine drives a fixed pool of decode *slots* through four stages
every step — admit (queue -> free slots), prefill (assemble the ragged
token batch), decode (one adapter step over the active rows only) and
retire (per-slot sampling, completion, slot release).  Per-slot math is
row-independent, so tokens under continuous batching equal a
single-stream run of the same request.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .metrics import EngineMetrics
from .queue import Admission, AdmissionQueue, EngineRequest

__all__ = ["DenseAdapter", "Engine", "EngineConfig", "PackedAdapter",
           "ServeStats", "greedy_sampler"]

#: engine stages, in execution order
STAGES = ("admit", "prefill", "decode", "retire")


def greedy_sampler(logits_row, request: EngineRequest) -> int:
    """Argmax over one slot's vocab row (refuses anything but one row)."""
    row = np.asarray(logits_row)
    if row.ndim != 1:
        raise ValueError(
            f"sampler expects one slot's logits row (1-D), got shape "
            f"{row.shape}; per-slot sampling is the engine's contract"
        )
    return int(row.argmax())


@dataclasses.dataclass
class ServeStats:
    """Counter block of a run."""

    steps: int = 0
    tokens_generated: int = 0
    completed: int = 0
    admitted: int = 0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine knobs."""

    batch_size: int
    max_seq: int
    #: queue capacity (None = unbounded)
    max_backlog: int | None = 64
    #: "continuous" refills slots as they free; "static" waits for the
    #: whole batch to drain (the baseline continuous batching beats)
    policy: str = "continuous"
    eos_token: int | None = None

    def __post_init__(self) -> None:
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.policy not in ("continuous", "static"):
            raise ValueError(
                f"policy must be 'continuous' or 'static', got {self.policy!r}"
            )


def _reset_state_slot(state: dict, i: int) -> None:
    """Zero slot ``i``'s clock and recurrent (Mamba) state, in place.
    Dense KV caches need no clearing (the per-row position mask hides
    stale entries); packed KV pages are cleared so their bytes do not
    depend on the slot's previous request."""
    state["pos"][i] = 0
    if "packed_kv" in state:
        state["packed_kv"].reset(i)
    if "ssm" in state:
        state["ssm"][:, :, i] = 0.0


class DenseAdapter:
    """Full-batch stepping over ``Model.decode_step`` (dense and hybrid
    families, unquantized weights).

    Inactive rows step with token 0 and their results are discarded, as
    in the reference: every step runs the whole batch.  Everything runs on
    the parameters' device.
    """

    def __init__(self, model, params: dict) -> None:
        self.model = model
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def init_state(self, batch_size: int, max_seq: int) -> dict:
        return self.model.init_decode_state(batch_size, max_seq,
                                            device=self.device)

    def reset_slot(self, state: dict, i: int) -> None:
        _reset_state_slot(state, i)

    def step(self, state: dict, tokens: np.ndarray,
             active: Sequence[int]) -> tuple[np.ndarray, dict]:
        """tokens: (n_active,) aligned with ``active`` slot ids.  Returns
        (f32 logits rows aligned with ``active``, new state)."""
        b = int(state["pos"].shape[0])
        toks = np.zeros(b, dtype=np.int64)
        toks[list(active)] = tokens
        logits, state = self.model.decode_step(
            self.params, state, torch.from_numpy(toks).to(self.device))
        return logits.to(torch.float32).cpu().numpy()[list(active)], state


class PackedAdapter:
    """Ragged-M stepping over a :class:`~repro_torch.tree.PackedTree`.

    Each step runs ``packed_decode_step`` with ``slot_ids`` = the active
    slots only.  ``kv="packed"`` keeps the KV cache as an Iris-packed
    :class:`~repro_torch.kvcache.PackedKVCache` (``kv_attention="dense"``
    decodes it to a dense oracle first).  With ``uploader`` set (a
    :class:`~repro_torch.engine.streams.StreamUploader`), each layer's
    stream words come through it instead of the tree's resident buffers:
    the next layer's upload overlaps this layer's matmuls.  Everything
    runs on the tree's device.
    """

    def __init__(self, cfg, tree, *, weights: str = "auto", uploader=None,
                 kv: str = "dense", kv_attention: str = "stream",
                 kv_bits: int | None = None, page_tokens: int = 8,
                 kv_m: int = 512) -> None:
        if kv not in ("dense", "packed"):
            raise ValueError(f"kv must be 'dense' or 'packed', got {kv!r}")
        if kv_attention not in ("stream", "dense"):
            raise ValueError(
                f"kv_attention must be 'stream' or 'dense', "
                f"got {kv_attention!r}")
        self.cfg = cfg
        self.tree = tree
        self.weights = weights
        self.uploader = uploader
        self.kv = kv
        self.kv_attention = kv_attention
        self.kv_bits = kv_bits
        self.page_tokens = page_tokens
        self.kv_m = kv_m

    @property
    def device(self) -> torch.device:
        return self.tree.device

    def init_state(self, batch_size: int, max_seq: int) -> dict:
        from ..models.quantized import init_decode_state

        state = init_decode_state(self.cfg, batch_size, max_seq, kv=self.kv,
                                  device=self.device)
        if self.kv == "packed":
            from ..kvcache import PackedKVCache

            bits = self.kv_bits if self.kv_bits is not None \
                else self.tree.spec.bits
            state["packed_kv"] = PackedKVCache.create(
                self.cfg, bits=bits, page_tokens=self.page_tokens,
                n_slots=batch_size, max_seq=max_seq, m=self.kv_m,
                device=self.device)
        return state

    def reset_slot(self, state: dict, i: int) -> None:
        _reset_state_slot(state, i)

    def step(self, state: dict, tokens: np.ndarray,
             active: Sequence[int]) -> tuple[np.ndarray, dict]:
        """tokens: (n_active,) aligned with ``active`` slot ids.  Returns
        (f32 logits rows aligned with ``active``, new state)."""
        from ..models.quantized import packed_decode_step

        dev = self.device
        logits, state = packed_decode_step(
            self.cfg, self.tree, state,
            torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                            device=dev),
            weights=self.weights,
            slot_ids=torch.as_tensor(list(active), dtype=torch.int64,
                                     device=dev),
            stream_source=self.uploader,
            kv=self.kv, kv_attention=self.kv_attention)
        return logits.to(torch.float32).cpu().numpy(), state

    def stream_bytes_uploaded(self) -> int | None:
        return self.uploader.bytes_uploaded if self.uploader else None

    def uploader_stats(self) -> dict | None:
        return self.uploader.stats() if self.uploader else None


class Engine:
    """Multi-tenant continuous-batching serving engine.

    Typical use::

        eng = Engine(PackedAdapter(cfg, tree), EngineConfig(4, 128))
        eng.submit(EngineRequest(uid=0, prompt=[1, 2], max_new_tokens=8))
        eng.run_until_drained()
        eng.metrics.snapshot()          # p50/p99 latency, tokens/s, ...
    """

    def __init__(self, adapter, config: EngineConfig, *,
                 sampler: Callable[[Any, EngineRequest], int] = greedy_sampler,
                 queue: AdmissionQueue | None = None,
                 metrics: EngineMetrics | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 hooks: dict[str, list] | None = None) -> None:
        self.adapter = adapter
        self.config = config
        self.sampler = sampler
        self.clock = clock
        self.queue = queue if queue is not None else AdmissionQueue(
            config.max_backlog, clock=clock)
        self.metrics = metrics if metrics is not None \
            else EngineMetrics(clock=clock)
        self.state = adapter.init_state(config.batch_size, config.max_seq)
        self.slots: list[EngineRequest | None] = [None] * config.batch_size
        self.slot_pos = np.zeros(config.batch_size, dtype=np.int64)
        self.hooks: dict[str, list] = {s: [] for s in STAGES}
        for stage, fns in (hooks or {}).items():
            for fn in fns:
                self.add_hook(stage, fn)
        self._stream_bytes_seen = 0
        self.admission_order: list[int] = []
        self.completion_order: list[int] = []

    def add_hook(self, stage: str,
                 fn: Callable[["Engine", str, dict], None]) -> None:
        """Register ``fn(engine, stage, ctx)`` to run after ``stage``."""
        if stage not in self.hooks:
            raise KeyError(f"unknown stage {stage!r}; stages are {STAGES}")
        self.hooks[stage].append(fn)

    def active_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def n_active(self) -> int:
        return len(self.active_slots())

    @property
    def stats(self) -> ServeStats:
        m = self.metrics
        return ServeStats(steps=m.steps, tokens_generated=m.tokens_generated,
                          completed=m.completed, admitted=m.admitted)

    def submit(self, req: EngineRequest) -> Admission:
        """Admit ``req`` to the backlog (or reject it with a reason)."""
        now = self.clock()
        self.metrics.record_submit(req.uid, now)
        adm = self.queue.submit(req, now)
        if not adm:
            self.metrics.record_reject(req.uid, adm.reason, now)
        return adm

    def _stage_admit(self, ctx: dict) -> None:
        """queue -> free slots, per the admission policy."""
        if self.config.policy == "static" and self.n_active:
            return
        now = self.clock()
        for i in range(self.config.batch_size):
            if self.slots[i] is not None:
                continue
            rejected0 = len(self.queue.rejections)
            req = self.queue.pop(now)
            for uid, reason in self.queue.rejections[rejected0:]:
                self.metrics.record_reject(uid, reason, now)
            if req is None:
                break
            self.slots[i] = req
            self.slot_pos[i] = 0
            req.status = "active"
            self.adapter.reset_slot(self.state, i)
            self.metrics.record_admit(req.uid, now)
            self.admission_order.append(req.uid)
            ctx.setdefault("admitted", []).append((i, req.uid))

    def _stage_prefill(self, ctx: dict) -> None:
        """Prompt token for prompt-phase slots, last sampled otherwise."""
        active = self.active_slots()
        toks = np.zeros(len(active), dtype=np.int32)
        for j, i in enumerate(active):
            req = self.slots[i]
            p = int(self.slot_pos[i])
            if p < len(req.prompt):
                toks[j] = req.prompt[p]
            elif req.generated:
                toks[j] = req.generated[-1]
        ctx["active"] = active
        ctx["tokens"] = toks

    def _stage_decode(self, ctx: dict) -> None:
        """One adapter step over the active rows (ragged M)."""
        active = ctx["active"]
        if not active:
            ctx["logits"] = np.zeros((0, 0), np.float32)
            return
        logits, self.state = self.adapter.step(self.state, ctx["tokens"],
                                               active)
        ctx["logits"] = logits
        self.metrics.record_step(len(active))
        bytes_fn = getattr(self.adapter, "stream_bytes_uploaded", None)
        uploaded = bytes_fn() if bytes_fn is not None else None
        if uploaded is not None:
            self.metrics.record_stream_bytes(
                uploaded - self._stream_bytes_seen)
            self._stream_bytes_seen = uploaded
        stats_fn = getattr(self.adapter, "uploader_stats", None)
        stats = stats_fn() if stats_fn is not None else None
        if stats is not None:
            self.metrics.record_uploader_stats(stats)

    def _stage_retire(self, ctx: dict) -> None:
        """Per-slot sampling, completion checks, slot release."""
        now = self.clock()
        for j, i in enumerate(ctx["active"]):
            req = self.slots[i]
            self.slot_pos[i] += 1
            p = int(self.slot_pos[i])
            if p < len(req.prompt):
                continue
            tok = self.sampler(ctx["logits"][j], req)
            if not req.generated:
                self.metrics.record_first_token(req.uid, now)
            req.generated.append(tok)
            self.metrics.record_token(req.uid)
            eos = self.config.eos_token
            if (len(req.generated) >= req.max_new_tokens
                    or (eos is not None and tok == eos)
                    or p >= self.config.max_seq - 1):
                req.done = True
                req.status = "done"
                self.metrics.record_complete(req.uid, now)
                self.completion_order.append(req.uid)
                self.slots[i] = None
                ctx.setdefault("retired", []).append((i, req.uid))

    def step(self) -> dict:
        """Run one admit -> prefill -> decode -> retire cycle."""
        ctx: dict = {}
        for stage in STAGES:
            getattr(self, f"_stage_{stage}")(ctx)
            for fn in self.hooks[stage]:
                fn(self, stage, ctx)
        return ctx

    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def run_until_drained(self, max_steps: int = 10_000) -> ServeStats:
        """Step until queue and slots are empty (or ``max_steps``)."""
        steps0 = self.metrics.steps
        while self.has_work():
            if self.metrics.steps - steps0 >= max_steps:
                break
            self.step()
        return self.stats
