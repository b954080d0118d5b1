"""repro_torch.engine: continuous-batching serving engine over packed or
dense weights (port of ``src/repro/engine``: queue, metrics, scheduler)."""
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

__all__ = [
    "Admission",
    "AdmissionQueue",
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
    "greedy_sampler",
    "percentile",
]
