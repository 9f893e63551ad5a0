"""The optimizer of the port's training path, after ``repro/optim``."""
from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_lr

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr"]
