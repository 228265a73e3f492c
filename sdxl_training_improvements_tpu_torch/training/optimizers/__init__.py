"""Optimizer registry.

Port of ``sdxl_training_improvements_tpu/training/optimizers/__init__.py``
(``make_optimizer``, ``_make_base``):

* ``adamw_bf16``                -> bf16 AdamW with stochastic rounding
  (per-leaf layout, hash noise; bf16 or int8 moments)
* ``adamw_schedule_free_kahan`` -> schedule-free AdamW with Kahan summation
* ``soap``                      -> SOAP (Adam in Shampoo's eigenbasis)
* ``adamw``                     -> plain ``optax.adamw`` (fp32 baseline)

``training.ema_decay`` wraps any of them in the fp32 weight EMA, except
schedule-free, which is refused as in JAX.  What is not ported raises
``NotImplementedError`` naming its ROADMAP item: the host-streamed state
(``shift_host`` / ``moments_host``), ``sr_noise="rbg"`` and
``tpu.flat_optimizer="on"``.
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
           "schedule_free_eval_params", "make_optimizer"]


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
    base = _make_base(oc, tpu, kind)
    return with_ema(base, decay=ema_decay) if ema_decay else base


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
    if oc.shift_host or oc.moments_host:
        raise NotImplementedError(
            "optimizer.shift_host/moments_host: host-streamed optimizer "
            "state is a 16 GB-chip memory plan with no counterpart on the "
            "80 GB card (ROADMAP, not ported)")
    if tpu is not None and str(tpu.flat_optimizer).lower() in ("on", "true"):
        raise NotImplementedError(
            "tpu.flat_optimizer (the flat/stacked/hybrid layouts) is not "
            "ported yet (ROADMAP queue 1, item 7)")
    # JAX's per-leaf layout draws "rbg" planes unless tpu.sr_noise says
    noise = tpu.sr_noise if tpu is not None else "rbg"
    if noise != "hash":
        raise NotImplementedError(
            f"sr_noise {noise!r} is not ported yet (ROADMAP queue 1, "
            "item 7)")
    return AdamWBF16(**common,
                     moments="int8" if oc.moments_8bit else "bf16")
