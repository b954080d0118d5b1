"""One reader per metric, found by the metric's name.

Each ``<metric>.py`` defines ``read(run) -> float | None`` over a
:class:`perfbench.record.RunRecord`; ``None`` means it found nothing to
read in this run (the kernel it times did not run, or no device trace),
and the harness leaves the metric out.  A kernel's reader also holds the
count of that kernel's work: operations and bytes from the shapes of the
configuration, the least any implementation has to move, never what one
implementation happens to read.
"""
