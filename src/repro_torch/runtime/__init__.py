"""repro_torch.runtime: the fault-tolerant train loop, elastic
resharding and pipeline stages (port of ``src/repro/runtime``)."""
from .train_loop import (
    TrainLoopConfig,
    TrainReport,
    device_batch,
    run_training,
)

__all__ = ["TrainLoopConfig", "TrainReport", "device_batch", "run_training"]
