"""The synthetic token pipeline (port of ``repro/data``)."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
