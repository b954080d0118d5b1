"""The one traffic generator: requests from a mix's parameters and a seed.

A mix file (``perfbench/traffic/<name>.json``) gives the closed loop's
clients (the engine has one slot for each), ``max_seq``, and the length
distributions of prompts and outputs.  Lengths come from a fixed pool:
``pool`` (prompt, output) pairs at evenly spaced quantiles of each
clipped log-normal, paired by a permutation fixed by the mix, so every
seed serves the same sizes.  The seed sets only their order (a fresh one
for each pass over the pool) and the token ids (uniform over the
vocabulary), so runs with different seeds do nearly the same work.

Each client's first request keeps a uniform share (drawn from the seed)
of its output, as though the loop had been running before the benchmark
joined it; the first completions then spread out at once instead of
arriving in lock-step.

``order_seed``: where a mix gives one, the order of the pool and the
shares kept of the first outputs come from it and not from the run's
seed, so every seed serves the same sizes in the same order and draws
only the token ids.  A mix whose window holds about one pass over a pool
of heavy-tailed lengths needs it: in a seeded order each seed's window
holds another share of output tokens.
"""
from __future__ import annotations

import math
import statistics

import numpy as np

#: the seed of the pairing permutation, part of every mix's definition
PAIRING_SEED = 0x5EED


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at quantiles ``(i + 0.5) / n`` of a log-normal with
    ``median`` and ``sigma``, rounded and clipped to ``[min, max]``."""
    if dist.get("dist", "lognormal") != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    z = statistics.NormalDist()
    out = [dist["median"] * math.exp(dist["sigma"] * z.inv_cdf((i + 0.5) / n))
           for i in range(n)]
    return np.clip(np.rint(out), dist["min"], dist["max"]).astype(np.int64)


class RequestSource:
    """Requests in the order clients send them: ``next()`` gives
    ``(prompt token ids, max_new_tokens)``."""

    def __init__(self, mix: dict, vocab_size: int, seed: int) -> None:
        n = int(mix["pool"])
        prompts = quantile_lengths(mix["prompt_tokens"], n)
        outputs = quantile_lengths(mix["output_tokens"], n)
        outputs = outputs[np.random.default_rng(PAIRING_SEED).permutation(n)]
        self.pairs = np.stack([prompts, outputs], axis=1)
        self.vocab_size = int(vocab_size)
        self.rng = np.random.default_rng([int(seed), 1])
        self.order_rng = self.rng if mix.get("order_seed") is None else \
            np.random.default_rng([int(mix["order_seed"]), 3])
        self.order: list[int] = []

    def next(self, first: bool = False) -> tuple[list[int], int]:
        if not self.order:
            self.order = self.order_rng.permutation(len(self.pairs)).tolist()
        p, o = (int(x) for x in self.pairs[self.order.pop()])
        prompt = self.rng.integers(0, self.vocab_size, p).tolist()
        if first:
            o = max(1, math.ceil(o * float(self.order_rng.random())))
        return prompt, o
