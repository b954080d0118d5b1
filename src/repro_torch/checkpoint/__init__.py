"""repro_torch.checkpoint: dense and packed checkpoints in the reference's
on-disk format (port of ``src/repro/checkpoint``)."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
