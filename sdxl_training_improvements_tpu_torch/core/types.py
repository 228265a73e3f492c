"""Dtype policy: ``training.mixed_precision`` to the model's dtypes.

Port of ``sdxl_training_improvements_tpu/core/types.py`` (``DataType``,
``Policy``, ``ModelWeightDtypes``) onto torch dtypes:

* ``bf16`` -> bf16 params, compute and output;
* ``fp16`` -> fp16 params, compute and output;
* ``no`` (and the fp32 aliases) -> fp32 everywhere.

An unknown name raises ``ValueError``, as ``DataType.from_str`` does.
``SDXLModel.create(policy=...)`` and ``SDXLModel.from_config`` read it.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class DataType(enum.Enum):
    FLOAT_32 = "float32"
    FLOAT_16 = "float16"
    BFLOAT_16 = "bfloat16"

    @classmethod
    def from_str(cls, name: str) -> "DataType":
        key = name.strip().lower()
        aliases = {
            "fp32": cls.FLOAT_32, "float32": cls.FLOAT_32,
            "float": cls.FLOAT_32, "no": cls.FLOAT_32, "none": cls.FLOAT_32,
            "fp16": cls.FLOAT_16, "float16": cls.FLOAT_16,
            "half": cls.FLOAT_16,
            "bf16": cls.BFLOAT_16, "bfloat16": cls.BFLOAT_16,
        }
        if key not in aliases:
            raise ValueError(f"Unknown dtype name: {name!r}")
        return aliases[key]

    @classmethod
    def from_torch(cls, dtype: torch.dtype) -> "DataType":
        return {torch.float32: cls.FLOAT_32, torch.float16: cls.FLOAT_16,
                torch.bfloat16: cls.BFLOAT_16}[dtype]

    def to_torch(self) -> torch.dtype:
        return {DataType.FLOAT_32: torch.float32,
                DataType.FLOAT_16: torch.float16,
                DataType.BFLOAT_16: torch.bfloat16}[self]


@dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: param, compute and output dtypes."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_mixed_precision(cls, mixed_precision: str) -> "Policy":
        """``bf16`` and ``fp16`` keep params, compute and output in that
        dtype (the pure-bf16 regime of the JAX package); ``no`` is fp32
        everywhere."""
        ct = DataType.from_str(mixed_precision).to_torch()
        if ct == torch.float32:
            return cls(torch.float32, torch.float32, torch.float32)
        return cls(param_dtype=ct, compute_dtype=ct, output_dtype=ct)


@dataclass(frozen=True)
class ModelWeightDtypes:
    """Per-component weight dtypes; the VAE is pinned to fp32."""

    unet: DataType = DataType.BFLOAT_16
    text_encoder: DataType = DataType.BFLOAT_16
    text_encoder_2: DataType = DataType.BFLOAT_16
    vae: DataType = DataType.FLOAT_32
    lora: DataType = DataType.FLOAT_32
    embedding: DataType = DataType.FLOAT_32

    @classmethod
    def from_single_dtype(cls, dtype: DataType) -> "ModelWeightDtypes":
        return cls(unet=dtype, text_encoder=dtype, text_encoder_2=dtype,
                   vae=DataType.FLOAT_32, lora=dtype, embedding=dtype)
