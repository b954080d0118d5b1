"""``itl_p95_ms``: 95th percentile of every gap between consecutive output
tokens of every request, both tokens in the window: what a reader of a
streamed answer feels."""
from perfbench.record import percentile


def read(run) -> float | None:
    gaps = [b - a for log in run.requests
            for a, b in zip(log.token_times, log.token_times[1:])
            if run.in_window(a) and run.in_window(b)]
    return percentile(gaps, 95) * 1e3 if gaps else None
