"""repro_torch.optim: AdamW and gradient compression (port of
``src/repro/optim``)."""
from .adamw import AdamWConfig, adamw_update, init_opt_state, lr_schedule
from .compression import GradCompressor

__all__ = ["AdamWConfig", "GradCompressor", "adamw_update",
           "init_opt_state", "lr_schedule"]
