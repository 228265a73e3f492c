"""Image sampling with classifier-free guidance, in PyTorch.

Port of ``ValidationSampler`` from ``sdxl_training_improvements_tpu/
training/validation.py``: ``method`` "ddpm" (v-prediction or epsilon)
walks the sigma-space samplers (the ZTSNR Karras-Euler or DPM++(2M)),
"flow_matching" the OT Euler ODE; DeepCache on the sigma-space samplers;
the img2img entry, the inpainting channels and the base->refiner handoff;
aesthetic-score rows for 5-time-id (refiner) UNets; and
``latents_to_images``.  Mesh serving is not ported (ROADMAP queue 1, item
14): passing a mesh raises.
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
    """``method`` picks the sampler family the UNet was trained for:
    "ddpm" -> the sigma-space ``sampler`` ("euler" or "dpmpp_2m");
    "flow_matching" -> ``schedules.sample_flow``.  ``deep_cache_interval``
    k > 1 runs the full UNet every k-th step and only its shallow stages
    around the cached deep feature in between (sigma-space samplers
    only)."""

    def __init__(self, model, tokenizers, schedule: S.NoiseSchedule,
                 num_inference_steps: int = 28, guidance_scale: float = 5.0,
                 method: str = "ddpm", mesh=None, sampler: str = "euler",
                 deep_cache_interval: int = 1):
        if method not in ("ddpm", "flow_matching"):
            raise ValueError(
                f"ValidationSampler supports methods 'ddpm' and "
                f"'flow_matching', got {method!r}")
        if sampler not in ("euler", "dpmpp_2m"):
            raise ValueError(
                f"sampler must be 'euler' or 'dpmpp_2m', got {sampler!r}")
        if sampler != "euler" and method == "flow_matching":
            raise ValueError(
                "dpmpp_2m is a sigma-space sampler; flow_matching models "
                "integrate the OT ODE (sampler='euler' only)")
        if deep_cache_interval < 1:
            raise ValueError(
                f"deep_cache_interval must be >= 1, got {deep_cache_interval}")
        if deep_cache_interval > 1 and method == "flow_matching":
            raise ValueError(
                "deep_cache is wired for the sigma-space samplers only")
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported (ROADMAP queue 1, item 14)")
        self.model = model
        self.tokenizers = tokenizers
        self.schedule = schedule
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        self.method = method
        self.sampler = sampler
        self.deep_cache_interval = deep_cache_interval
        # log of the trained sigma table, fp32 as the JAX sampler forms it
        self._log_sigmas = np.log(np.maximum(
            schedule.sigmas.numpy().astype(np.float32), np.float32(1e-8)))

    def _conditioning(self, enc, n: int, height: int, width: int,
                      aesthetic_score: float = 6.0,
                      negative_aesthetic_score: float = 2.5):
        """[cond; neg]-ordered encoder output -> CFG-stacked [uncond; cond]
        prompt embeds, pooled embeds and time ids: [h, w, 0, 0, h, w] for
        6-id UNets, [h, w, 0, 0, score] for 5-id ones (the refiner; the
        negative score on the uncond rows)."""
        pe = torch.cat([enc["prompt_embeds"][n:], enc["prompt_embeds"][:n]])
        pooled = torch.cat([enc["pooled_prompt_embeds"][n:],
                            enc["pooled_prompt_embeds"][:n]])
        if self.model.unet_config.num_time_ids == 5:
            rows = ([[height, width, 0, 0, negative_aesthetic_score]] * n
                    + [[height, width, 0, 0, aesthetic_score]] * n)
        else:
            rows = [[height, width, 0, 0, height, width]] * (2 * n)
        time_ids = torch.tensor(rows, dtype=torch.float32, device=pe.device)
        return pe, pooled, time_ids

    def timestep_index(self, sigma: float) -> int:
        """Nearest trained timestep to ``sigma`` in log space.  sigma = inf
        (the ZTSNR first step) maps to index 0, the index JAX's argmin
        returns over that all-inf distance vector."""
        if math.isinf(sigma):
            return 0
        target = np.log(np.maximum(np.float32(sigma), np.float32(1e-8)))
        return int(np.argmin(np.abs(self._log_sigmas - target)))

    def _unet_batch(self, x, extra):
        """[x; x] for the CFG rows, with the conditioning channels."""
        x2 = torch.cat([x, x])
        if extra is not None:
            x2 = torch.cat([x2, extra.to(x2.dtype)], dim=1)
        return x2

    def _cfg(self, pred):
        uncond, cond = pred.float().chunk(2)
        return uncond + self.guidance_scale * (cond - uncond)

    def _denoiser(self, prompt_embeds, pooled, time_ids, extra=None):
        """model_fn(x, sigma): the raw network at t(sigma) on the doubled
        batch [uncond; cond], combined in fp32 with the guidance scale.
        ``extra`` ([2B, K, h, w], CFG-stacked already) joins the input's
        channels every call: the inpainting mask and masked latents."""
        def fn(x, sigma):
            t = torch.full((2 * x.shape[0],), self.timestep_index(sigma),
                           dtype=torch.int64, device=x.device)
            return self._cfg(self.model.unet_apply(
                self._unet_batch(x, extra), t, prompt_embeds, pooled,
                time_ids))

        return fn

    def _cached_denoiser(self, prompt_embeds, pooled, time_ids, extra=None):
        """DeepCache ``_denoiser``: ``(x, sigma, (step, deep)) ->
        (cfg_pred, (step + 1, deep'))``.  A step with step % k == 0 runs
        the full UNet and refreshes the deep feature; the others run the
        shallow stages around the cached one."""
        k = self.deep_cache_interval

        def fn(x, sigma, aux):
            step, deep = aux
            t = torch.full((2 * x.shape[0],), self.timestep_index(sigma),
                           dtype=torch.int64, device=x.device)
            args = (self._unet_batch(x, extra), t, prompt_embeds, pooled,
                    time_ids)
            if step % k == 0:
                pred, deep = self.model.unet_apply(*args, return_deep=True)
            else:
                pred = self.model.unet_apply(*args, deep_cache=deep)
            return self._cfg(pred), (step + 1, deep)

        return fn

    def _flow_denoiser(self, prompt_embeds, pooled, time_ids, extra=None):
        """model_fn(x, t) -> CFG velocity; the UNet takes the float time t
        in [0, 1] itself (the flow-matching training convention)."""
        def fn(x, t):
            tvec = torch.full((2 * x.shape[0],), float(t),
                              dtype=torch.float32, device=x.device)
            return self._cfg(self.model.unet_apply(
                self._unet_batch(x, extra), tvec, prompt_embeds, pooled,
                time_ids))

        return fn

    @torch.inference_mode()
    def generate(self, prompts: Sequence[str],
                 generator: Optional[torch.Generator] = None,
                 height: int = 1024, width: int = 1024,
                 negative_prompts: Optional[Sequence[str]] = None,
                 noise: Optional[torch.Tensor] = None,
                 init_latents: Optional[torch.Tensor] = None,
                 strength: float = 1.0,
                 extra_channels: Optional[torch.Tensor] = None,
                 aesthetic_score: float = 6.0,
                 negative_aesthetic_score: float = 2.5,
                 denoising_start: Optional[float] = None,
                 denoising_end: Optional[float] = None,
                 return_latents: bool = False):
        """One image per prompt as HWC uint8 arrays (or the latents).

        ``noise`` [n, C_lat, h/f, w/f] replaces the sampler's draw from
        ``generator``.  ``init_latents`` + ``strength`` run img2img;
        ``extra_channels`` [n, K, h/f, w/f] join the UNet input every step
        (inpainting); ``denoising_start``/``denoising_end`` are the
        base->refiner handoff; ``return_latents`` skips the VAE decode."""
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
        pe, pooled, time_ids = self._conditioning(
            enc, n, height, width, aesthetic_score, negative_aesthetic_score)
        extra = None
        if extra_channels is not None:
            extra_channels = extra_channels.to(device)
            extra = torch.cat([extra_channels, extra_channels])
        f = self.model.vae.config.downscale_factor
        lat_ch = self.model.unet_config.in_channels - (
            0 if extra_channels is None else extra_channels.shape[1])
        lat_shape = (n, lat_ch, height // f, width // f)
        if init_latents is not None:
            if tuple(init_latents.shape) != lat_shape:
                raise ValueError(
                    f"init_latents shape {tuple(init_latents.shape)} != "
                    f"expected {lat_shape}")
            init_latents = init_latents.to(device)
        if noise is not None:
            noise = noise.to(device)
        kw = dict(num_steps=self.num_inference_steps, noise=noise,
                  generator=generator, device=device, init=init_latents,
                  strength=strength)
        if self.method == "flow_matching":
            if denoising_start is not None or denoising_end is not None:
                raise ValueError("denoising_start/denoising_end (the "
                                 "base->refiner sigma handoff) apply to the "
                                 "sigma-space sampler only, not "
                                 "flow_matching")
            latents = S.sample_flow(
                self._flow_denoiser(pe, pooled, time_ids, extra),
                lat_shape, **kw)
        else:
            if self.deep_cache_interval > 1:
                model_fn = self._cached_denoiser(pe, pooled, time_ids, extra)
                # (step, deep): step 0 always refreshes, so no placeholder
                aux0 = (0, None)
            else:
                model_fn = self._denoiser(pe, pooled, time_ids, extra)
                aux0 = None
            sample = (S.sample_dpmpp_2m if self.sampler == "dpmpp_2m"
                      else S.sample_ztsnr)
            latents = sample(model_fn, lat_shape, self.schedule,
                             denoising_start=denoising_start,
                             denoising_end=denoising_end, aux0=aux0, **kw)
        if return_latents:
            return latents
        return latents_to_images(self.model.decode_latents(latents))
