"""Typed configuration of the training slice, in plain dataclasses.

Port of ``sdxl_training_improvements_tpu/config.py`` (``ModelConfig``,
``OptimizerConfig``, ``TrainingConfig``, ``TPUConfig`` and the root
``Config`` with ``from_dict``): the same fields, defaults and validation,
so a config dict that the JAX package takes means the same here.  The
``data`` / ``global_config`` / ``tag_weighting`` sections and
``from_yaml`` are not ported yet (ROADMAP queue 1, data and loop; the
card's machine has no pyyaml); ``from_dict`` ignores unknown sections as
the JAX merge ignores unknown keys.  ``TPUConfig`` keeps its name and
fields: the trainer reads ``remat``, ``micro_batch_size``,
``grad_accum_dtype`` and ``sr_noise`` from it, and refuses the settings
the port does not take yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ModelConfig:
    pretrained_model_name: str = "stabilityai/stable-diffusion-xl-base-1.0"
    model_type: str = "sdxl"
    prediction_type: str = "v_prediction"  # epsilon | v_prediction
    num_timesteps: int = 1000
    sigma_min: float = 0.002
    sigma_max: float = 20000.0
    use_ztsnr: bool = True
    timestep_bias_strategy: str = "none"  # none | earlier | later | range
    timestep_bias_min: float = 0.0
    timestep_bias_max: float = 1.0
    timestep_bias_portion: float = 0.25
    timestep_bias_multiplier: float = 2.0
    min_snr_gamma: Optional[float] = 5.0
    rho: float = 7.0
    aesthetic_score: float = 6.0


@dataclass
class OptimizerConfig:
    learning_rate: float = 1e-6
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    optimizer_type: str = "adamw_bf16"
    moments_8bit: bool = False
    shift_host: bool = False
    moments_host: bool = False
    # schedule-free
    warmup_steps: int = 0
    kahan_sum: bool = True
    correct_bias: bool = True
    # SOAP
    precondition_frequency: int = 10
    shampoo_beta: float = 0.95
    max_precond_dim: int = 10000
    precondition_1d: bool = False
    merge_dims: bool = True
    normalize_grads: bool = False
    data_format: str = "channels_first"

    @property
    def betas(self) -> tuple:
        return (self.beta1, self.beta2)


@dataclass
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = False
    steps_offset: int = 0
    timestep_spacing: str = "leading"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    rescale_betas_zero_snr: bool = True


@dataclass
class MethodConfig:
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)


@dataclass
class LoRAConfig:
    enabled: bool = False
    rank: int = 4
    alpha: float = 1.0
    dropout: float = 0.0
    targets: Optional[List[str]] = None


@dataclass
class TrainingConfig:
    method: str = "ddpm"  # ddpm | flow_matching
    num_epochs: int = 10
    batch_size: int = 4
    gradient_accumulation_steps: int = 1
    mixed_precision: str = "bf16"
    enable_xformers: bool = True
    num_workers: int = 4
    prediction_type: str = "v_prediction"
    method_config: MethodConfig = field(default_factory=MethodConfig)
    save_every: int = 1
    pin_memory: bool = True
    clip_grad_norm: float = 1.0
    num_inference_steps: int = 50
    debug_mode: bool = False
    save_final_model: bool = True
    save_best: bool = True
    max_steps: Optional[int] = None
    resume_from: Optional[str] = None
    seed: int = 42
    proportion_empty_prompts: float = 0.0
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    ema_decay: Optional[float] = None


@dataclass
class TPUConfig:
    """Device and step settings.  The name and fields are the JAX
    package's; on the card ``mesh_shape``/``shard_params`` have no
    counterpart yet (ROADMAP queue 1, multi-GPU)."""

    mesh_shape: Optional[List[int]] = None
    axis_names: List[str] = field(
        default_factory=lambda: ["data", "fsdp", "tensor"])
    shard_params: bool = False
    remat: bool = True
    remat_policy: str = "full"
    attention_impl: str = "auto"
    attn_chunk_mb: Optional[int] = None
    # re-tiles the global batch (batch_size * accumulation) into
    # micro-batches of this size; None = batch_size
    micro_batch_size: Optional[int] = None
    grad_accum_dtype: str = "float32"  # float32 | bfloat16
    flat_optimizer: str = "auto"
    sr_noise: str = "hash"  # hash | rbg
    donate_state: bool = True
    async_checkpointing: bool = True
    profile_dir: Optional[str] = None

    def __post_init__(self):
        if self.attention_impl not in ("auto", "xla", "chunked", "flash"):
            raise ValueError(
                f"tpu.attention_impl must be one of auto|xla|chunked|flash, "
                f"got {self.attention_impl!r}")
        if str(self.flat_optimizer).lower() not in ("auto", "on", "off",
                                                    "true", "false"):
            raise ValueError(
                f"tpu.flat_optimizer must be one of auto|on|off, "
                f"got {self.flat_optimizer!r}")
        if self.sr_noise not in ("hash", "rbg"):
            raise ValueError(
                f"tpu.sr_noise must be hash|rbg, got {self.sr_noise!r}")
        if self.grad_accum_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"tpu.grad_accum_dtype must be float32|bfloat16, "
                f"got {self.grad_accum_dtype!r}")
        if self.micro_batch_size is not None and self.micro_batch_size < 1:
            raise ValueError(
                f"tpu.micro_batch_size must be >= 1 or null, "
                f"got {self.micro_batch_size}")
        if self.attn_chunk_mb is not None and self.attn_chunk_mb < 1:
            raise ValueError(
                f"tpu.attn_chunk_mb must be >= 1 or null, "
                f"got {self.attn_chunk_mb}")


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        """Overlay ``raw`` on the defaults, recursively; unknown keys are
        ignored.  The legacy ``tpu.use_pallas_attention`` bool becomes
        ``tpu.attention_impl``, as in the JAX package."""
        raw = dict(raw or {})
        tpu_raw = raw.get("tpu")
        if isinstance(tpu_raw, dict) and "use_pallas_attention" in tpu_raw:
            tpu_raw = dict(tpu_raw)
            legacy = tpu_raw.pop("use_pallas_attention")
            tpu_raw.setdefault("attention_impl", "auto" if legacy else "xla")
            raw["tpu"] = tpu_raw
        cfg = cls()
        _merge_into_dataclass(cfg, raw)
        cfg.tpu.__post_init__()  # validate the merged values
        return cfg


def _merge_into_dataclass(obj: Any, data: Dict[str, Any]) -> Any:
    """Overlay ``data`` onto dataclass ``obj`` in place: dicts merge into
    nested dataclasses, other values replace the default."""
    names = {f.name for f in dataclasses.fields(obj)}
    for key, value in (data or {}).items():
        if key not in names:
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise ValueError(
                    f"Config section {key!r} must be a mapping, got "
                    f"{type(value).__name__}: {value!r}")
            _merge_into_dataclass(current, value)
        else:
            setattr(obj, key, value)
    return obj
