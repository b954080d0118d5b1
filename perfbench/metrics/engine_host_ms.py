"""``engine_host_ms``: host milliseconds a step spends outside the
``decode`` stage (admit, prefill's token assembly, retire with host
sampling, the client loop), from the benchmark's spans at the engine's
stage hooks, averaged over the window's steps."""


def read(run) -> float | None:
    if not run.steps:
        return None
    return sum(s.host_s for s in run.steps) / len(run.steps) * 1e3
