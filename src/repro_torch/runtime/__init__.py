"""repro_torch.runtime: the fault-tolerant train loop (port of
``src/repro/runtime``)."""
from .train_loop import (
    TrainLoopConfig,
    TrainReport,
    device_batch,
    run_training,
)

__all__ = ["TrainLoopConfig", "TrainReport", "device_batch", "run_training"]
