"""Model-level enums and shared contracts.

Counterpart of reference ``src/models/base.py``: ``ModelType`` with
case-insensitive lookup (``:17-30``) and ``TimestepBiasStrategy``
(``:33-38``).  The reference's ``BaseModel`` ABC dissolves into the
design (modules are ``torch.nn.Module``s; the bundle is
``models/sdxl.SDXLModel``), but the enums remain part of the public config
surface.
"""
from __future__ import annotations

import enum


class ModelType(enum.Enum):
    BASE = "base"
    INPAINTING = "inpainting"
    REFINER = "refiner"
    SDXL = "sdxl"
    SDXL_TINY = "sdxl_tiny"

    @classmethod
    def from_str(cls, name: str) -> "ModelType":
        key = name.strip().lower().replace("-", "_")
        if key == "tiny":  # accepted shorthand for the test miniature
            return cls.SDXL_TINY
        for m in cls:
            if m.value == key:
                return m
        raise ValueError(f"Unknown model type: {name!r}. "
                         f"Valid: {[m.value for m in cls]}")


class TimestepBiasStrategy(enum.Enum):
    NONE = "none"
    EARLIER = "earlier"
    LATER = "later"
    RANGE = "range"

    @classmethod
    def from_str(cls, name: str) -> "TimestepBiasStrategy":
        key = name.strip().lower()
        for m in cls:
            if m.value == key:
                return m
        raise ValueError(f"Unknown timestep bias strategy: {name!r}")
