"""Template for new training methods.

Port of ``sdxl_training_improvements_tpu/training/methods/
example_method.py`` (reference ``methods/example_method.py``).  Copy this
file, rename the method, implement the numerics and select it with
``training.method`` in the config; nothing else is wired
(``docs/extending.md``).  The registered ``example_method`` trains the
UNet as a plain denoising autoencoder: predict the clean latents from
noisy ones at a fixed mid-schedule timestep.  It is trivial on purpose and
runs end to end as it stands.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sdxl_training_improvements_tpu_torch.training.methods import (
    _apply_tag_weights, _finite_guard, _per_sample, register_method)


@register_method("example_method")
def example_method_loss(unet_apply, batch,
                        generator: Optional[torch.Generator], schedule, mcfg
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x = batch["vae_latents"].float()
    dev = x.device

    # 1. the method's randomness: the trainer's per-sample seeds keep the
    #    method exactly re-tilable by tpu.micro_batch_size; a direct call
    #    draws from ``generator``
    noise = batch.get("noise")
    if noise is None:
        noise = _per_sample(
            batch.get("sample_seeds"), 0, dev,
            lambda g: torch.randn(x.shape[1:], generator=g, device=dev),
            lambda g: torch.randn(x.shape, generator=g, device=dev),
            generator)

    # 2. the model input (here: a fixed mid-schedule noise level)
    t = torch.full((x.shape[0],), schedule.num_timesteps // 2,
                   dtype=torch.int64, device=dev)
    noisy = schedule.add_noise(x, noise, t)

    # 3. one UNet call
    pred = unet_apply(noisy, t, batch["prompt_embeds"],
                      batch["pooled_prompt_embeds"], batch["time_ids"]
                      ).float()

    # 4. the method's loss, as a mean of per-sample terms
    per_sample = ((pred - x) ** 2).mean(dim=(1, 2, 3))

    # 5. the standard tail: tag weighting and the finite guard (keep them)
    per_sample = _apply_tag_weights(per_sample, batch)
    loss = _finite_guard(per_sample.mean())

    return loss, {"loss": loss.detach(),
                  "pred_scale": pred.detach().abs().mean()}
