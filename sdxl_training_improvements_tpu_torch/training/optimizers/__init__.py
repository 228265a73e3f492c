"""Optimizer registry.

Port of ``sdxl_training_improvements_tpu/training/optimizers/__init__.py``
(``make_optimizer``, ``_make_base``):

* ``adamw_bf16``                -> bf16 AdamW with stochastic rounding
  (per-leaf or flat layout, hash or rbg noise, bf16 or int8 moments,
  resident or host-streamed state)
* ``adamw_schedule_free_kahan`` -> schedule-free AdamW with Kahan summation
* ``soap``                      -> SOAP (Adam in Shampoo's eigenbasis)
* ``adamw``                     -> plain ``optax.adamw`` (fp32 baseline)

``training.ema_decay`` wraps any of them in the fp32 weight EMA, except
schedule-free, which is refused as in JAX.  ``tpu.flat_optimizer``
resolves as JAX's ``resolve_flat_state`` does ("auto" and "off": per-leaf,
"on": flat, refused under model sharding), and ``tpu.sr_noise`` picks the
noise (None without a ``tpu`` section: JAX's per-layout default).
Host-streamed state is refused under ``tpu.shard_params``, as in JAX.
"""
from __future__ import annotations

from sdxl_training_improvements_tpu_torch.training.optimizers.adamw import (
    AdamW, AdamWState)
from sdxl_training_improvements_tpu_torch.training.optimizers.adamw_bf16 \
    import DECAY_THRESHOLD, AdamWBF16, AdamWBF16State
from sdxl_training_improvements_tpu_torch.training.optimizers.ema import (
    EMA, EMAState, ema_eval_params, unwrap_ema, with_ema)
from sdxl_training_improvements_tpu_torch.training.optimizers.schedule_free \
    import (AdamWScheduleFreeKahan, ScheduleFreeKahanState,
            schedule_free_eval_params)
from sdxl_training_improvements_tpu_torch.training.optimizers.soap import (
    SOAP, SOAPState)

__all__ = ["AdamW", "AdamWState", "AdamWBF16", "AdamWBF16State",
           "AdamWScheduleFreeKahan", "ScheduleFreeKahanState", "SOAP",
           "SOAPState", "EMA", "EMAState", "DECAY_THRESHOLD",
           "ema_eval_params", "unwrap_ema", "with_ema",
           "schedule_free_eval_params", "make_optimizer",
           "resolve_flat_state"]


def make_optimizer(config):
    """Build the optimizer from the root ``Config`` (or an
    ``OptimizerConfig``), wrapped in the weight EMA when
    ``training.ema_decay`` is set.  As in JAX, the ``adamw_bf16`` settings
    (layout, int8 moments, noise, host-streamed state) apply to it
    alone."""
    oc = config.optimizer if hasattr(config, "optimizer") else config
    tpu = getattr(config, "tpu", None)
    kind = oc.optimizer_type.lower()
    ema_decay = getattr(getattr(config, "training", None), "ema_decay",
                        None)
    if kind not in ("adamw_bf16", "adamw_schedule_free_kahan", "soap",
                    "adamw"):
        raise ValueError(f"Unsupported optimizer type: {oc.optimizer_type}")
    if ema_decay and kind == "adamw_schedule_free_kahan":
        raise ValueError(
            "training.ema_decay cannot be combined with the schedule-free "
            "optimizer: schedule-free training IS a weight-averaging scheme "
            "(its x sequence is the shipped model, recovered at export); an "
            "EMA of the y training iterate would shadow that recovery with "
            "ill-defined weights. Disable one of the two.")
    if (getattr(oc, "shift_host", False)
            or getattr(oc, "moments_host", False)) and getattr(
            tpu, "shard_params", False):
        raise ValueError(
            "optimizer.shift_host/moments_host cannot be combined with "
            "tpu.shard_params: host-streamed state is a single-chip 16 GB "
            "memory plan; on a sharded mesh the optimizer state is already "
            "ZeRO-partitioned across chips. Disable one of the two.")
    base = _make_base(oc, tpu, kind)
    return with_ema(base, decay=ema_decay) if ema_decay else base


def resolve_flat_state(tpu_cfg) -> bool:
    """JAX ``resolve_flat_state``: ``tpu.flat_optimizer`` "on" (or
    "true") is the flat layout, "auto" and "off" per-leaf; "on" is refused
    under model sharding (``tpu.shard_params`` or a tensor mesh axis)."""
    if tpu_cfg is None:
        return False
    choice = str(getattr(tpu_cfg, "flat_optimizer", "off")).lower()
    if choice not in ("on", "true"):
        return False
    mesh_shape = getattr(tpu_cfg, "mesh_shape", None)
    tensor_sharded = bool(mesh_shape) and len(mesh_shape) >= 3 \
        and mesh_shape[2] > 1
    if getattr(tpu_cfg, "shard_params", False) or tensor_sharded:
        raise ValueError(
            "tpu.flat_optimizer=on cannot be combined with model sharding "
            "(tpu.shard_params / a tensor mesh axis): the per-leaf sharding "
            "rules do not apply to flat buffers.")
    return True


def _make_base(oc, tpu, kind: str):
    common = dict(lr=oc.learning_rate, betas=(oc.beta1, oc.beta2),
                  eps=oc.epsilon, weight_decay=oc.weight_decay)
    if kind == "adamw":
        return AdamW(**common)
    if kind == "adamw_schedule_free_kahan":
        return AdamWScheduleFreeKahan(
            **common, warmup_steps=oc.warmup_steps, kahan_sum=oc.kahan_sum,
            correct_bias=oc.correct_bias)
    if kind == "soap":
        return SOAP(**common, shampoo_beta=oc.shampoo_beta,
                    precondition_frequency=oc.precondition_frequency,
                    max_precond_dim=oc.max_precond_dim,
                    merge_dims=oc.merge_dims,
                    precondition_1d=oc.precondition_1d,
                    normalize_grads=oc.normalize_grads,
                    correct_bias=oc.correct_bias)
    return AdamWBF16(**common, flat_state=resolve_flat_state(tpu),
                     noise=getattr(tpu, "sr_noise", None),
                     moments="int8" if oc.moments_8bit else "bf16",
                     shift_host=oc.shift_host, moments_host=oc.moments_host)
