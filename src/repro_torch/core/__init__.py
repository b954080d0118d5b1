"""The port's own copy of the Iris layout core (``src/repro/core``):
problem spec, scheduler, layout IR and the lowered execution plans."""
