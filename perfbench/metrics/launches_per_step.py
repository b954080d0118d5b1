"""``launches_per_step``: kernel launches the host made per step, counted
from the runtime's launch calls in the profiler's trace of the traced
steps."""


def read(run) -> float | None:
    tr = run.trace
    if tr is None or not tr.launches or not tr.steps:
        return None
    return tr.launches / len(tr.steps)
