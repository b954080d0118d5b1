"""The traced steps: ``torch.profiler`` over a few steps of the running loop.

The benchmark marks each engine step (``bench.step``) and, inside it,
the adapter's model step (``bench.model_step``) with
``record_function``.  From the profiler's raw events it keeps every
device operation (kernels, copies, fills) with its interval, counts the
runtime's kernel-launch calls, and labels each stretch of device idle
time by what the host's main thread was doing at its midpoint: the
region (``model step``, ``engine`` outside it, or the benchmark's
``loop``) and the innermost host operation there.
"""
from __future__ import annotations

import time

from .record import TraceRecord

STEP = "bench.step"
MODEL = "bench.model_step"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def _is_annotation(ev) -> bool:
    fn = getattr(ev, "is_user_annotation", None)
    return ev.name().startswith("bench.") or bool(fn and fn())


def _profiled(loop, n_steps: int, acts, cuda: bool, device):
    """``n_steps`` steps of ``loop`` under a profiler of ``acts``, each
    step and the adapter's model step marked: ``(events, wall_s,
    step records)``."""
    import torch
    from torch.profiler import profile, record_function

    adapter = loop.engine.adapter
    real = adapter.step

    def model_step(*args, **kw):
        with record_function(MODEL):
            return real(*args, **kw)

    adapter.step = model_step
    first = len(loop.steps)
    try:
        if cuda:
            torch.cuda.synchronize(device)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                with record_function(STEP):
                    loop.step()
            if cuda:
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    finally:
        del adapter.step
    return prof.profiler.kineto_results.events(), wall, loop.steps[first:]


def profile_steps(loop, n_steps: int, label_steps: int, device
                  ) -> TraceRecord:
    """Two profiled stretches of the running loop.  ``n_steps`` under
    the device's activity alone give the device operations, the launches
    and the busy share: host-side profiling adds its own cost to every
    operator call, which would open idle gaps a run without it does not
    have.  Then ``label_steps`` with the host's operators recorded too
    label the idle time by what the host was doing."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    if cuda:
        events, wall, steps = _profiled(loop, n_steps,
                                        [ProfilerActivity.CUDA], cuda, device)
        timed = reduce_events(events, wall, steps)
    events, wall, steps = _profiled(
        loop, label_steps,
        [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
        cuda, device)
    labelled = reduce_events(events, wall, steps)
    if not cuda:
        return labelled
    if not timed.launches:           # no runtime events without host ones
        timed.launches = round(labelled.launches * len(timed.steps)
                               / max(1, len(labelled.steps)))
    timed.idle_by_host = labelled.idle_by_host
    return timed


def reduce_events(events, wall: float, steps) -> TraceRecord:
    """Device operations, launches and labelled idle time from the raw
    profiler events of the traced steps."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type() == DeviceType.CPU]
    marks = [e for e in host if e.name() == STEP]
    if marks:
        main = marks[0].start_thread_id()
        lo = min(e.start_ns() for e in marks)
        hi = max(e.end_ns() for e in marks)
    else:                         # device activity alone: the whole profile
        main = None
        lo, hi = 0, 1 << 62
    device = sorted(
        ((e.name(), e.start_ns(), e.duration_ns()) for e in events
         if e.device_type() == DeviceType.CUDA and not _is_annotation(e)
         and lo <= e.start_ns() <= hi),
        key=lambda d: d[1])
    launches = sum(1 for e in host if e.name() in LAUNCHES
                   and lo <= e.start_ns() <= hi)
    gaps, end = [], lo
    for _, start, dur in device:
        if start > end:
            gaps.append((end, start))
        end = max(end, start + dur)
    if hi > end:
        gaps.append((end, hi))
    idle: dict[str, float] = {}
    if main is not None:
        spans = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in host
                        if e.start_thread_id() == main), key=lambda s: s[0])
        for (a, b), label in zip(gaps, _labels(spans, [(a + b) / 2
                                                       for a, b in gaps])):
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    dev = [(n, s * 1e-9, d * 1e-9) for n, s, d in device] if device else []
    return TraceRecord(wall, list(steps), dev, launches, idle)


def _labels(spans, mids) -> list[str]:
    """For each midpoint (ascending), the region and the innermost host
    span that contains it, by a sweep over the main thread's nested
    spans."""
    out, stack, i = [], [], 0
    for m in mids:
        while i < len(spans) and spans[i][0] <= m:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        names = [s[2] for s in stack]
        region = "model step" if MODEL in names else \
            "engine" if STEP in names else "loop"
        inner = names[-1] if names and not names[-1].startswith("bench.") \
            else "python"
        out.append(f"{region}: {inner}")
    return out
