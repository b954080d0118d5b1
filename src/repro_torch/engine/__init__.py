"""repro_torch.engine: continuous-batching serving engine over packed or
dense weights (port of ``src/repro/engine``: queue, metrics, scheduler,
the stream uploader)."""
from .metrics import EngineMetrics, RequestTiming, percentile
from .queue import (
    REJECT_BACKLOG_FULL,
    REJECT_DEADLINE_EXPIRED,
    Admission,
    AdmissionQueue,
    EngineRequest,
)
from .scheduler import (
    STAGES,
    DenseAdapter,
    Engine,
    EngineConfig,
    PackedAdapter,
    ServeStats,
    greedy_sampler,
)
from .streams import BufferRing, StreamUploader

__all__ = [
    "Admission",
    "AdmissionQueue",
    "BufferRing",
    "DenseAdapter",
    "Engine",
    "EngineConfig",
    "EngineMetrics",
    "EngineRequest",
    "PackedAdapter",
    "REJECT_BACKLOG_FULL",
    "REJECT_DEADLINE_EXPIRED",
    "RequestTiming",
    "STAGES",
    "ServeStats",
    "StreamUploader",
    "greedy_sampler",
    "percentile",
]
