"""Typed configuration tree, in plain dataclasses.

Port of ``sdxl_training_improvements_tpu/config.py``: every section
(``model``, ``optimizer``, ``training``, ``data``, ``global_config.{cache,
logging,image}``, ``tag_weighting``, ``tpu``) with the same fields,
defaults and validation, and the root ``Config`` with ``from_dict``,
``from_yaml`` and ``save_yaml``, so a config file that the JAX package
takes means the same here.  The card's machine has no pyyaml: the files
are read and written by the port's own reader of the configs' YAML subset
(``_yaml.py``), which resolves scalars as ``yaml.safe_load`` does.
Unknown keys are ignored, as in the JAX merge.  ``TPUConfig`` keeps its
name and fields: the trainer reads ``remat``, ``micro_batch_size``,
``grad_accum_dtype``, ``sr_noise``, ``async_checkpointing`` and
``profile_dir`` from it, and refuses the settings the port does not take
yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from sdxl_training_improvements_tpu_torch import _yaml


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
class ImageConfig:
    supported_dims: List[List[int]] = field(
        default_factory=lambda: [
            [640, 1536],
            [768, 1344],
            [832, 1216],
            [896, 1152],
            [1024, 1024],
            [1152, 896],
            [1216, 832],
            [1344, 768],
            [1536, 640],
        ]
    )
    max_aspect_ratio: float = 2.4
    target_size: List[int] = field(default_factory=lambda: [1024, 1024])
    max_size: List[int] = field(default_factory=lambda: [1536, 1536])
    min_size: List[int] = field(default_factory=lambda: [384, 384])
    bucket_step: int = 64


@dataclass
class CacheConfig:
    cache_dir: Union[str, Path] = "cache"
    max_cache_size: int = 10000
    use_cache: bool = True
    cache_latents: bool = True
    cache_text_embeddings: bool = True
    # one cache per rank under <cache_dir>/host-NNN (multi-process runs:
    # each rank encodes and reads only its static share of the dataset)
    partitioned: bool = False

    @property
    def persistent(self) -> bool:
        """Whether the precompute cache persists on disk across runs: any
        of the three knobs false puts it in a per-run temporary directory
        (precompute still runs; JAX ``CacheConfig.persistent``)."""
        return bool(self.use_cache and self.cache_latents
                    and self.cache_text_embeddings)


@dataclass
class LoggingConfig:
    use_wandb: bool = False
    wandb_project: str = "sdxl-training"
    wandb_entity: Optional[str] = None
    log_dir: str = "logs"
    filename: str = "training.log"
    console_level: str = "INFO"
    file_level: str = "DEBUG"
    capture_warnings: bool = True
    log_every: int = 10


@dataclass
class DataConfig:
    train_data_dir: Union[str, List[str]] = field(
        default_factory=lambda: ["data/train"])
    validation_data_dir: Optional[Union[str, List[str]]] = None
    image_size: int = 1024
    center_crop: bool = True
    random_flip: bool = True
    tokenizer_max_length: int = 77
    validation_prompts: List[str] = field(default_factory=list)


@dataclass
class GlobalConfig:
    cache: CacheConfig = field(default_factory=CacheConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    image: ImageConfig = field(default_factory=ImageConfig)


@dataclass
class TagWeightingConfig:
    enable_tag_weighting: bool = False
    use_cache: bool = True
    required: bool = False
    min_weight: float = 0.1
    max_weight: float = 3.0
    default_weight: float = 1.0
    smoothing_factor: float = 0.05


@dataclass
class TPUConfig:
    """Device and step settings.  The name and fields are the JAX
    package's.  On the cards ``mesh_shape`` is [data, fsdp, tensor] over
    the ranks (one card each, ``parallel/mesh.py``; None: every rank on
    data) and ``shard_params`` shards the large leaves over fsdp as JAX
    places them (``parallel/zero.py``): each rank stores its chunk of the
    parameter, its gradient, its optimizer state and its EMA shadow, and
    the UNet gathers each unit's chunks to run it (under LoRA the pairs
    stay whole, their state sharded).  A tensor axis above 1 splits the
    UNet's transformer blocks megatron-style (``parallel/mesh.py``
    ``tp_plan``)."""

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
    data: DataConfig = field(default_factory=DataConfig)
    global_config: GlobalConfig = field(default_factory=GlobalConfig)
    tag_weighting: TagWeightingConfig = field(
        default_factory=TagWeightingConfig)
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

    @classmethod
    def from_yaml(cls, path: Union[str, Path]) -> "Config":
        """The config in the YAML file at ``path`` over the defaults; a
        missing file gives ``Config()``, as in the JAX package."""
        path = Path(path)
        if not path.exists():
            return cls()
        raw = _yaml.load_file(path) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: the config must be a mapping at the "
                             f"top level, got {type(raw).__name__}")
        return cls.from_dict(raw)

    def save_yaml(self, path: Union[str, Path]) -> None:
        Path(path).write_text(_yaml.dump(self.to_dict()), encoding="utf-8")


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
