"""What a run records, and what every metric reader reads.

The benchmark's own spans sit at the engine's stage hooks: a step runs
``admit -> prefill -> decode -> retire`` and a hook fires after each, so
a :class:`StepRecord` holds the step's start and the end of each stage on
the host's clock.  Each request's send time, token times and completion
are stamped by the benchmark's client loop.
"""
from __future__ import annotations

import dataclasses


def percentile(values: list[float], p: float) -> float:
    """Linear-interpolated percentile (numpy's default), ``p`` in [0, 100]."""
    if not values:
        raise ValueError("percentile of an empty sample")
    xs = sorted(values)
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


@dataclasses.dataclass
class StepRecord:
    """One engine step: host times (s) at its start and after each
    stage, the active rows, the KV tokens they attend over (each row's
    position + 1, summed) and the output tokens it produced."""

    t0: float
    t_admit: float = 0.0
    t_prefill: float = 0.0
    t_decode: float = 0.0
    t_end: float = 0.0
    rows: int = 0
    kv_tokens: int = 0
    tokens: int = 0

    @property
    def host_s(self) -> float:
        """Host seconds outside the decode stage."""
        return (self.t_end - self.t0) - (self.t_decode - self.t_prefill)


@dataclasses.dataclass
class RequestLog:
    uid: int
    client: int
    prompt: list[int]
    max_new: int
    sent: float
    tokens: list[int] = dataclasses.field(default_factory=list)
    token_times: list[float] = dataclasses.field(default_factory=list)
    done: float | None = None


@dataclasses.dataclass
class TraceRecord:
    """The profiled steps: their wall seconds, their step records, every
    device operation ``(name, start_s, dur_s)``, the kernel launches the
    host made, and the device's idle time by what the host was doing."""

    window_s: float
    steps: list[StepRecord]
    device: list[tuple[str, float, float]]
    launches: int
    idle_by_host: dict[str, float]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of
        their intervals)."""
        busy, end = 0.0, float("-inf")
        for _, start, dur in sorted(self.device, key=lambda e: e[1]):
            stop = start + dur
            if stop <= end:
                continue
            busy += stop - max(start, end)
            end = stop
        return busy

    def kernel_s(self, part: str) -> float:
        """Device seconds of operations whose name contains ``part``."""
        return sum(d for n, _, d in self.device if part in n)


@dataclasses.dataclass
class RunRecord:
    shape: object            # perfbench.spec.ModelShape
    quant: dict
    mix: dict
    setup_s: float
    w0: float
    w1: float
    steps: list[StepRecord]
    requests: list[RequestLog]
    trace: TraceRecord | None = None

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def in_window(self, t: float) -> bool:
        return self.w0 < t <= self.w1
