"""repro_torch.data: the synthetic LM token pipeline (port of
``src/repro/data``)."""
from .pipeline import PipelineState, SyntheticLMPipeline

__all__ = ["PipelineState", "SyntheticLMPipeline"]
