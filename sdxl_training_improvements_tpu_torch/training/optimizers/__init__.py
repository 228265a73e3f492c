"""Optimizer registry.

Port of ``sdxl_training_improvements_tpu/training/optimizers/__init__.py``
for what the training slice runs: ``adamw_bf16`` with the per-leaf layout,
bf16 moments, resident state and hash noise (the JAX defaults), and plain
``adamw`` (``optax.adamw``, the fp32 baseline).  Every other selection
raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Union

from sdxl_training_improvements_tpu_torch.training.optimizers.adamw import (
    AdamW, AdamWState)
from sdxl_training_improvements_tpu_torch.training.optimizers.adamw_bf16 \
    import DECAY_THRESHOLD, AdamWBF16, AdamWBF16State

__all__ = ["AdamW", "AdamWState", "AdamWBF16", "AdamWBF16State",
           "DECAY_THRESHOLD", "make_optimizer"]

_QUEUE = "is not ported yet (ROADMAP queue 1: the remaining training " \
    "features)"


def make_optimizer(config) -> Union[AdamWBF16, AdamW]:
    """Build the optimizer from the root ``Config`` (or an
    ``OptimizerConfig``).  As in JAX, the ``adamw_bf16`` settings (its
    layout, int8 moments, noise, host-streamed state) do not apply to
    plain ``adamw``."""
    oc = config.optimizer if hasattr(config, "optimizer") else config
    tpu = getattr(config, "tpu", None)
    kind = oc.optimizer_type.lower()
    if kind not in ("adamw_bf16", "adamw_schedule_free_kahan", "soap",
                    "adamw"):
        raise ValueError(f"Unsupported optimizer type: {oc.optimizer_type}")
    if kind not in ("adamw_bf16", "adamw"):
        raise NotImplementedError(f"optimizer_type {kind!r} {_QUEUE}")
    if getattr(getattr(config, "training", None), "ema_decay", None):
        raise NotImplementedError(f"training.ema_decay (EMA) {_QUEUE}")
    if kind == "adamw":
        return AdamW(lr=oc.learning_rate, betas=(oc.beta1, oc.beta2),
                     eps=oc.epsilon, weight_decay=oc.weight_decay)
    if oc.moments_8bit:
        raise NotImplementedError(f"optimizer.moments_8bit {_QUEUE}")
    if oc.shift_host or oc.moments_host:
        raise NotImplementedError(
            "optimizer.shift_host/moments_host: host-streamed optimizer "
            "state is a 16 GB-chip memory plan with no counterpart on the "
            "80 GB card (ROADMAP, not ported)")
    if tpu is not None and str(tpu.flat_optimizer).lower() in ("on", "true"):
        raise NotImplementedError(
            f"tpu.flat_optimizer (the flat/stacked/hybrid layouts) {_QUEUE}")
    # JAX's per-leaf layout draws "rbg" planes unless tpu.sr_noise says
    noise = tpu.sr_noise if tpu is not None else "rbg"
    if noise != "hash":
        raise NotImplementedError(f"sr_noise {noise!r} {_QUEUE}")
    return AdamWBF16(lr=oc.learning_rate, betas=(oc.beta1, oc.beta2),
                     eps=oc.epsilon, weight_decay=oc.weight_decay)
