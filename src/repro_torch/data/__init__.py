"""The token pipeline of the port's training path, after ``repro/data``."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
