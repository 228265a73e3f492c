"""Text-to-image pipeline, in PyTorch.

Port of ``SDXLPipeline`` from ``sdxl_training_improvements_tpu/
pipelines.py``: ``from_model`` and text-to-image ``__call__`` through the
ZTSNR Karras-Euler sampler with classifier-free guidance, for
``method="ddpm"`` (v-prediction or epsilon) UNets.

    model = SDXLModel.create(dtype=torch.bfloat16, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    pipe = SDXLPipeline.from_model(model)
    images = pipe(["a photograph of an astronaut riding a horse"],
                  height=1024, width=1024, num_inference_steps=28,
                  guidance_scale=5.0, seed=0)
    images[0]  # HWC uint8 numpy array

Loading a diffusers checkpoint (``from_pretrained``), the DPM++(2M) and
flow-matching samplers, DeepCache, img2img, inpainting and the refiner come
in later slices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.tokenizer import (
    TokenizerPair)
from sdxl_training_improvements_tpu_torch.training.schedules import (
    NoiseSchedule)
from sdxl_training_improvements_tpu_torch.training.validation import (
    ValidationSampler)


class SDXLPipeline:
    def __init__(self, model: SDXLModel, tokenizers: TokenizerPair,
                 schedule: Optional[NoiseSchedule] = None):
        self.model = model
        self.tokenizers = tokenizers
        self.schedule = schedule or NoiseSchedule.create()

    @classmethod
    def from_model(cls, model: SDXLModel,
                   tokenizers: Optional[TokenizerPair] = None,
                   schedule: Optional[NoiseSchedule] = None
                   ) -> "SDXLPipeline":
        if tokenizers is None:
            # the hash fallback must match this model's vocabulary
            tokenizers = TokenizerPair.fallback(
                vocab_size=model.clip_g.cfg.vocab_size)
        return cls(model, tokenizers, schedule)

    def __call__(self, prompts: Sequence[str], height: int = 1024,
                 width: int = 1024, num_inference_steps: int = 28,
                 guidance_scale: float = 5.0, seed: int = 0,
                 negative_prompts: Optional[Sequence[str]] = None,
                 noise: Optional[torch.Tensor] = None,
                 return_latents: bool = False) -> List[np.ndarray]:
        """Text -> image.  The initial noise is drawn from a generator on
        the model's device seeded with ``seed``, unless ``noise`` is
        given."""
        sampler = ValidationSampler(
            self.model, self.tokenizers, self.schedule,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale)
        generator = torch.Generator(device=self.model.device)
        generator.manual_seed(seed)
        return sampler.generate(list(prompts), generator, height=height,
                                width=width,
                                negative_prompts=negative_prompts,
                                noise=noise, return_latents=return_latents)
