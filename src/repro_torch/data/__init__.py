"""Data: the port of ``repro.data`` (the synthetic token pipeline)."""
from .pipeline import (  # noqa: F401
    DataConfig, DataState, TokenPipeline, global_batch_at,
)
