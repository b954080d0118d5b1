"""``ttft_p90_s``: 90th percentile, over every request whose first token
arrives in the window, of the time from the client's send to that
token."""
from perfbench.record import percentile


def read(run) -> float | None:
    waits = [log.token_times[0] - log.sent for log in run.requests
             if log.token_times and run.in_window(log.token_times[0])]
    return percentile(waits, 90) if waits else None
