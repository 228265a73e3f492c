"""Training methods as plain loss functions.

Port of ``sdxl_training_improvements_tpu/training/methods/__init__.py``:
a registry of loss functions, selected by ``config.training.method``.

Signature::

    loss_fn(unet_apply, batch, generator, schedule, mcfg) -> (loss, metrics)

``unet_apply(sample, timesteps, prompt_embeds, pooled_prompt_embeds,
time_ids)`` is the UNet with its own parameters (the JAX signature's
``params`` argument has no counterpart: a module holds its parameters).
``batch`` carries ``vae_latents`` [B, C, H, W], ``prompt_embeds``,
``pooled_prompt_embeds``, ``time_ids`` [B, 6] and optionally
``tag_weights`` [B].  Randomness:

* ``batch["noise"]`` / ``batch["timesteps"]``, when present, replace the
  draws (deterministic replay: the loss is a function of the batch);
* else ``batch["sample_seeds"]`` [B, 2] int64 (CPU), set by the trainer,
  keys each sample's noise and timestep by its position in the global
  batch, one ``torch.Generator`` per draw, so re-tiling the batch into
  micro-batches leaves every sample's draws unchanged;
* else ``generator`` draws for the whole micro-batch (a direct call).

The finite guard clamps the mean over the micro-batch.  Over several
ranks each holds a block of the micro-batch's rows, and ``mean_over``
(the mesh step's context) makes the guard decide on the mean over all
of them, as JAX's does on its global batch: a clamped mean clamps every
rank's loss and zeroes its gradient.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from sdxl_training_improvements_tpu_torch.training import schedules as S

LOSS_CLAMP = 1000.0  # reference finite-guard ceiling

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
LOSS_REGISTRY: Dict[str, LossFn] = {}


def register_method(name: str):
    def deco(fn: LossFn) -> LossFn:
        LOSS_REGISTRY[name] = fn
        return fn
    return deco


def get_method(name: str) -> LossFn:
    if name not in LOSS_REGISTRY:
        raise ValueError(f"Unknown training method: {name!r}. "
                         f"Available: {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name]


# (group, ranks): the ranks whose blocks make up one micro-batch
_MEAN_OVER = contextvars.ContextVar("sdxl_loss_mean_over", default=None)


@contextlib.contextmanager
def mean_over(group, ranks: int):
    """Within the block the finite guard decides on the mean of the
    ``ranks`` ranks of ``group`` (None: the default group); one rank
    changes nothing."""
    tok = _MEAN_OVER.set((group, ranks) if ranks > 1 else None)
    try:
        yield
    finally:
        _MEAN_OVER.reset(tok)


def _finite_guard(loss: torch.Tensor) -> torch.Tensor:
    """Non-finite -> 1000.0, else min(loss, 1000.0).  The double where
    keeps the gradient exactly zero (not NaN) on the discarded branch.
    Under ``mean_over`` the test is on the ranks' mean (a collective):
    a rank returns its own loss where that mean is finite and under the
    clamp, else 1000.0."""
    over = _MEAN_OVER.get()
    finite = torch.isfinite(loss)
    safe = torch.where(finite, loss, torch.zeros_like(loss))
    if over is not None:
        mean = loss.detach().float().clone()
        dist.all_reduce(mean, group=over[0])
        mean = mean / over[1]
        keep = torch.isfinite(mean) & (mean <= LOSS_CLAMP)
        return torch.where(keep, safe, torch.full_like(loss, LOSS_CLAMP))
    return torch.where(finite, torch.clamp(safe, max=LOSS_CLAMP),
                       torch.full_like(loss, LOSS_CLAMP))


def _finite_elements(err: torch.Tensor) -> torch.Tensor:
    """Overflowed squared errors become a large constant with zero
    gradient, so one inf element cannot poison the gradient with NaN."""
    return torch.where(torch.isfinite(err), err,
                       torch.full_like(err, LOSS_CLAMP))


def _apply_tag_weights(per_sample: torch.Tensor, batch) -> torch.Tensor:
    """``l_i *= w_i`` per sample; a 0-d loss gets ``loss * w.mean()``
    (the legacy scalar contract)."""
    tw = batch.get("tag_weights")
    if tw is None:
        return per_sample
    tw = tw.float().to(per_sample.device)
    if per_sample.dim() == 0:
        return per_sample * tw.mean()
    return per_sample * tw


def _generators(seeds: torch.Tensor, device, column: int):
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds[:, column].tolist()]


def _per_sample(seeds: Optional[torch.Tensor], column: int, device,
                draw_one, draw_all, generator):
    """Draw per sample from its own generator (``seeds`` [B, 2]), or for
    the whole batch from ``generator``."""
    if seeds is None:
        return draw_all(generator)
    return torch.stack([draw_one(g)
                        for g in _generators(seeds, device, column)])


def _timestep_weights(schedule: S.NoiseSchedule, mcfg):
    if getattr(mcfg, "timestep_bias_strategy", "none") == "none":
        return None
    n = schedule.num_timesteps
    return S.generate_timestep_weights(
        n, mcfg.timestep_bias_strategy,
        bias_portion=getattr(mcfg, "timestep_bias_portion", 0.25),
        bias_multiplier=getattr(mcfg, "timestep_bias_multiplier", 2.0),
        bias_begin=int(getattr(mcfg, "timestep_bias_min", 0.0) * n),
        bias_end=int(getattr(mcfg, "timestep_bias_max", 1.0) * n))


@register_method("ddpm")
def ddpm_loss(unet_apply, batch, generator: Optional[torch.Generator],
              schedule: S.NoiseSchedule, mcfg
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """DDPM / v-prediction loss with ZTSNR and MinSNR: noise and timesteps,
    ``add_noise``, the UNet's prediction against eps or the reference's
    velocity (eps - x)/sigma, MinSNR-weighted per-sample MSE, tag weights,
    finite guard."""
    x = batch["vae_latents"]
    dev = x.device
    seeds = batch.get("sample_seeds")
    noise = batch.get("noise")
    if noise is None:
        noise = _per_sample(
            seeds, 0, dev,
            lambda g: torch.randn(x.shape[1:], generator=g, device=dev),
            lambda g: torch.randn(x.shape, generator=g, device=dev),
            generator)
    t = batch.get("timesteps")
    if t is None:
        weights = _timestep_weights(schedule, mcfg)
        t = _per_sample(
            seeds, 1, dev,
            lambda g: schedule.sample_timesteps(g, 1, weights, dev)[0],
            lambda g: schedule.sample_timesteps(g, x.shape[0], weights, dev),
            generator)

    x32 = x.float()
    noisy = schedule.add_noise(x32, noise, t)
    pred = unet_apply(noisy, t, batch["prompt_embeds"],
                      batch["pooled_prompt_embeds"], batch["time_ids"]
                      ).float()
    if schedule.prediction_type == "v_prediction":
        target = schedule.get_velocity(x32, noise, t)
    else:
        target = noise.float()

    mse = _finite_elements((pred - target) ** 2)
    per_sample = mse.mean(dim=(1, 2, 3))
    if schedule.min_snr_gamma is not None:
        per_sample = per_sample * schedule.min_snr_weight(t)
    per_sample = _apply_tag_weights(per_sample, batch)
    loss = _finite_guard(per_sample.mean())

    with torch.no_grad():
        tf = t.float()
        metrics = {"loss": loss.detach(), "timestep_mean": tf.mean(),
                   "timestep_std": tf.std(correction=0),
                   "noise_scale": noise.abs().mean(),
                   "pred_scale": pred.abs().mean()}
    return loss, metrics


@register_method("flow_matching")
def flow_matching_loss(unet_apply, batch,
                       generator: Optional[torch.Generator],
                       schedule: S.NoiseSchedule, mcfg
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Optimal-transport flow matching with logit-normal times:
    t ~ sigmoid(N(0, 1)), x0 ~ N(0, I), xt = (1 - t) x0 + t x1, target
    x1 - x0, per-sample MSE, one UNet call."""
    x1 = batch["vae_latents"].float()
    dev = x1.device
    seeds = batch.get("sample_seeds")
    t = batch.get("timesteps")
    if t is None:
        t = _per_sample(
            seeds, 1, dev,
            lambda g: S.sample_logit_normal(g, (), device=dev),
            lambda g: S.sample_logit_normal(g, (x1.shape[0],), device=dev),
            generator)
    x0 = batch.get("noise")
    if x0 is None:
        x0 = _per_sample(
            seeds, 0, dev,
            lambda g: torch.randn(x1.shape[1:], generator=g, device=dev),
            lambda g: torch.randn(x1.shape, generator=g, device=dev),
            generator)
    x0 = x0.float()

    xt = S.optimal_transport_path(x0, x1, t)
    v_pred = unet_apply(xt, t, batch["prompt_embeds"],
                        batch["pooled_prompt_embeds"], batch["time_ids"]
                        ).float()
    v_true = S.flow_matching_target(x0, x1)
    per_sample = _finite_elements((v_pred - v_true) ** 2).mean(
        dim=(1, 2, 3))
    per_sample = _apply_tag_weights(per_sample, batch)
    loss = _finite_guard(per_sample.mean())

    with torch.no_grad():
        metrics = {"loss": loss.detach(), "x0_norm": x0.norm(),
                   "x1_norm": x1.norm(), "velocity_norm": v_pred.norm(),
                   "time_mean": t.float().mean(),
                   "time_std": t.float().std(correction=0)}
    return loss, metrics


# the extension template registers itself (JAX: the same import)
from sdxl_training_improvements_tpu_torch.training.methods import (  # noqa: E402,F401,E501
    example_method as _example_method)
