"""Deterministic, shardable, checkpointable synthetic token pipeline.

Own copy of ``src/repro/data/pipeline.py`` (numpy only), so the port
imports nothing of the reference: the batches are the reference's byte
for byte.  ``runtime.train_loop.device_batch`` moves one to the device.

Produces language-modeling batches from a seeded Markov-ish token
generator (so losses actually *decrease* during the example training runs
— the stream has learnable structure).  The pipeline state is a single
(step, seed) pair: restoring a checkpoint resumes the exact stream, and
each data-parallel host can slice its shard deterministically
(``host_slice``) — no coordination required, which is what survives
elastic re-scaling.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def as_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d: dict) -> "PipelineState":
        return PipelineState(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLMPipeline:
    """Structured synthetic stream: tokens follow a degree-2 recurrence
    ``t[i] = (a * t[i-1] + b * t[i-2] + 7) % K`` over a small *active set*
    K = min(vocab, 97), with occasional noise jumps over the full vocab.
    The restriction to K matters: modulo the full vocab the next-token
    map is a pseudo-random permutation a small model cannot fit in a few
    hundred steps (measured); over ~100 tokens the transitions are
    memorizable and the loss drops well under the uniform floor."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, noise: float = 0.05,
                 active_vocab: int | None = None):
        self.vocab_size = vocab_size
        self.active = min(vocab_size, active_vocab or 97)
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.noise = noise
        self.state = PipelineState(seed=seed, step=0)

    # ------------------------------------------------------------------
    def _gen_batch(self, step: int, lo: int, hi: int) -> dict:
        """Rows [lo, hi) of the global batch for ``step``."""
        n = hi - lo
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, step]))
        # draw the whole batch's row params, slice our shard (cheap,
        # keeps every host bit-identical on overlapping rows)
        a = rng.integers(1, 8, size=self.global_batch)
        b = rng.integers(0, 8, size=self.global_batch)
        t0 = rng.integers(0, self.active, size=(self.global_batch, 2))
        flip = rng.random((self.global_batch, self.seq_len + 1))
        jump = rng.integers(0, self.vocab_size,
                            size=(self.global_batch, self.seq_len + 1))
        a, b, t0 = a[lo:hi], b[lo:hi], t0[lo:hi]
        flip, jump = flip[lo:hi], jump[lo:hi]
        toks = np.empty((n, self.seq_len + 1), dtype=np.int64)
        toks[:, 0] = t0[:, 0]
        toks[:, 1] = t0[:, 1]
        for i in range(2, self.seq_len + 1):
            nxt = (a * toks[:, i - 1] + b * toks[:, i - 2] + 7) \
                % self.active
            noisy = flip[:, i] < self.noise
            toks[:, i] = np.where(noisy, jump[:, i], nxt)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def next_batch(self, lo: int = 0, hi: int | None = None) -> dict:
        """Advance one step; return rows [lo, hi) of the global batch."""
        hi = self.global_batch if hi is None else hi
        out = self._gen_batch(self.state.step, lo, hi)
        self.state.step += 1
        return out

    def peek_batch(self, step: int, lo: int = 0, hi: int | None = None
                   ) -> dict:
        hi = self.global_batch if hi is None else hi
        return self._gen_batch(step, lo, hi)

    # ------------------------------------------------------------------
    def host_slice(self, host_id: int, n_hosts: int) -> tuple[int, int]:
        if self.global_batch % n_hosts:
            raise ValueError(
                f"global batch {self.global_batch} not divisible by "
                f"{n_hosts} hosts")
        per = self.global_batch // n_hosts
        return host_id * per, (host_id + 1) * per

    # checkpoint integration -------------------------------------------
    def state_dict(self) -> dict:
        return self.state.as_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState.from_dict(d)
