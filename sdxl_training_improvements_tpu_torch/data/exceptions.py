"""Context-carrying exception hierarchy for the data pipeline.

Counterpart of the reference's ``src/data/preprocessing/exceptions.py:8-147``:
every error carries a structured ``context`` dict so failures in long
preprocessing runs are diagnosable from logs alone.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class PreprocessingError(Exception):
    """Base: message + structured context."""

    def __init__(self, message: str,
                 context: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.context = dict(context or {})

    def __str__(self) -> str:
        base = super().__str__()
        if self.context:
            ctx = ", ".join(f"{k}={v!r}" for k, v in self.context.items())
            return f"{base} ({ctx})"
        return base


class DataLoadError(PreprocessingError):
    """Image/caption file could not be read."""


class PipelineConfigError(PreprocessingError):
    """Invalid pipeline configuration."""


class CacheError(PreprocessingError):
    """Cache read/write/index failure."""


class DtypeError(PreprocessingError):
    """Unexpected tensor dtype."""


class TensorValidationError(PreprocessingError):
    """Shape/NaN/contiguity validation failure."""


class BucketingError(PreprocessingError):
    """Bucket assignment/validation failure."""


class TagProcessingError(PreprocessingError):
    """Tag extraction/weighting failure."""


class DeviceProcessingError(PreprocessingError):
    """On-device encode (VAE/CLIP) failure during precompute."""
