"""``device_idle``: share of the traced steps' wall time in which no
operation ran on the device."""


def read(run) -> float | None:
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
