"""``tokens_per_s``: output tokens produced in the window over the
window's seconds."""


def read(run) -> float:
    return sum(s.tokens for s in run.steps) / run.window_s
