"""Text-to-image sampling with classifier-free guidance, in PyTorch.

Port of ``ValidationSampler`` from ``sdxl_training_improvements_tpu/
training/validation.py`` for ``method="ddpm"`` with the ZTSNR Karras-Euler
sampler: conditioning, the CFG denoiser and ``generate``, plus
``latents_to_images``.  DPM++(2M), flow matching, DeepCache, img2img and
inpainting conditioning, and mesh serving come in later slices.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.training import schedules as S


def latents_to_images(decoded: torch.Tensor) -> List[np.ndarray]:
    """[-1, 1] NCHW float -> list of HWC uint8 arrays."""
    arr = decoded.float().clamp(-1, 1).cpu().numpy()
    arr = np.nan_to_num(arr, nan=0.0, posinf=1.0, neginf=-1.0)
    arr = ((arr + 1.0) * 127.5).astype(np.uint8)
    return [a.transpose(1, 2, 0) for a in arr]


class ValidationSampler:
    """Samples a v-prediction/epsilon (``method="ddpm"``) UNet with the
    ZTSNR Karras-Euler walk; the other methods and samplers come later."""

    def __init__(self, model, tokenizers, schedule: S.NoiseSchedule,
                 num_inference_steps: int = 28, guidance_scale: float = 5.0):
        self.model = model
        self.tokenizers = tokenizers
        self.schedule = schedule
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        # log of the trained sigma table, fp32 as the JAX sampler forms it
        self._log_sigmas = np.log(np.maximum(
            schedule.sigmas.numpy().astype(np.float32), np.float32(1e-8)))

    def _conditioning(self, enc, n: int, height: int, width: int):
        """[cond; neg]-ordered encoder output -> CFG-stacked [uncond; cond]
        prompt embeds, pooled embeds and [h, w, 0, 0, h, w] time ids."""
        pe = torch.cat([enc["prompt_embeds"][n:], enc["prompt_embeds"][:n]])
        pooled = torch.cat([enc["pooled_prompt_embeds"][n:],
                            enc["pooled_prompt_embeds"][:n]])
        if self.model.unet_config.num_time_ids != 6:
            raise ValueError("the port conditions 6-time-id UNets only")
        time_ids = torch.tensor([[height, width, 0, 0, height, width]],
                                dtype=torch.float32, device=pe.device
                                ).repeat(2 * n, 1)
        return pe, pooled, time_ids

    def timestep_index(self, sigma: float) -> int:
        """Nearest trained timestep to ``sigma`` in log space.  sigma = inf
        (the ZTSNR first step) maps to index 0, the index JAX's argmin
        returns over that all-inf distance vector."""
        if math.isinf(sigma):
            return 0
        target = np.log(np.maximum(np.float32(sigma), np.float32(1e-8)))
        return int(np.argmin(np.abs(self._log_sigmas - target)))

    def _denoiser(self, prompt_embeds, pooled, time_ids):
        """model_fn(x, sigma): the raw network at t(sigma) on the doubled
        batch [uncond; cond], combined in fp32 with the guidance scale."""
        guidance = self.guidance_scale

        def fn(x, sigma):
            b = x.shape[0]
            t = torch.full((2 * b,), self.timestep_index(sigma),
                           dtype=torch.int64, device=x.device)
            pred = self.model.unet_apply(torch.cat([x, x]), t, prompt_embeds,
                                         pooled, time_ids)
            uncond, cond = pred.float().chunk(2)
            return uncond + guidance * (cond - uncond)

        return fn

    @torch.inference_mode()
    def generate(self, prompts: Sequence[str],
                 generator: Optional[torch.Generator] = None,
                 height: int = 1024, width: int = 1024,
                 negative_prompts: Optional[Sequence[str]] = None,
                 noise: Optional[torch.Tensor] = None,
                 return_latents: bool = False):
        """One image per prompt as HWC uint8 arrays (or the latents).
        ``noise`` [n, 4, h/8, w/8] replaces the draw from ``generator``."""
        negs = (list(negative_prompts) if negative_prompts
                else [""] * len(prompts))
        if len(negs) != len(prompts):
            raise ValueError(f"negative_prompts ({len(negs)}) must match "
                             f"prompts ({len(prompts)})")
        device = self.model.device
        ids_l, ids_g = self.tokenizers(list(prompts) + negs)
        enc = self.model.encode_prompt(
            torch.as_tensor(ids_l, dtype=torch.int64, device=device),
            torch.as_tensor(ids_g, dtype=torch.int64, device=device))
        n = len(prompts)
        pe, pooled, time_ids = self._conditioning(enc, n, height, width)
        f = self.model.vae.config.downscale_factor
        lat_shape = (n, self.model.unet_config.in_channels, height // f,
                     width // f)
        if noise is not None:
            noise = noise.to(device)
        latents = S.sample_ztsnr(self._denoiser(pe, pooled, time_ids),
                                 lat_shape, self.schedule,
                                 num_steps=self.num_inference_steps,
                                 noise=noise, generator=generator,
                                 device=device)
        if return_latents:
            return latents
        return latents_to_images(self.model.decode_latents(latents))
