"""SDXL model bundle: UNet + VAE + dual CLIP, in PyTorch.

Port of ``sdxl_training_improvements_tpu/models/sdxl.py``: ``create`` with
seeded weights for all four components (three for the refiner, which has
no CLIP-L), ``unet_apply``, ``encode_prompt`` (dual CLIP -> prompt_embeds
[B, 77, 2048] + pooled [B, 1280]; CLIP-G alone for the refiner),
``encode_images`` and ``decode_latents``, ``trainable_params`` (the UNet's
parameters: the training slice trains the UNet only, as JAX does), and
``from_config``, which builds the bundle a ``Config`` asks for.  Dtypes
follow the JAX package: the UNet in the policy's compute dtype
(``core/types.py``; a bare ``dtype``, bf16 by default, otherwise), CLIP-L
and CLIP-G in ``weight_dtypes`` (by default that dtype), norms' parameters
fp32, the VAE fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn

from sdxl_training_improvements_tpu_torch.core.types import (
    DataType, ModelWeightDtypes, Policy)
from sdxl_training_improvements_tpu_torch.models.clip import (
    CLIPTextConfig, CLIPTextModel, encode_dual, encode_g)
from sdxl_training_improvements_tpu_torch.models.layers import (
    GroupNorm, LayerNormF32)
from sdxl_training_improvements_tpu_torch.models.unet import (
    SDXLUNet, UNetConfig)
from sdxl_training_improvements_tpu_torch.models.vae import (
    AutoencoderKL, VAEConfig)


def _init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in place, drawn from ``generator`` in a fixed order:
    LeCun-normal weights (std fan_in^-0.5) for linear, conv and token
    embeddings, N(0, 0.01) position embeddings, zero biases, unit norms."""
    def normal_(p, std):
        draw = torch.randn(p.shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
        p.copy_(draw * std)

    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (GroupNorm, LayerNormF32)):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                normal_(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                std = 0.01 if name.endswith("position_embedding") \
                    else m.weight.shape[1] ** -0.5
                normal_(m.weight, std)


def _materialize(module: nn.Module, dtype: torch.dtype, device,
                 generator: Optional[torch.Generator]) -> nn.Module:
    """Meta-built module -> weights on ``device``: ``dtype`` for weights,
    fp32 for norm parameters, convs' weights channels_last; seeded from
    ``generator``, or left unset when it is None (a checkpoint fills
    them)."""
    module = module.to_empty(device=device).to(dtype)
    for m in module.modules():
        if isinstance(m, (GroupNorm, LayerNormF32)):
            m.float()
    if generator is not None:
        _init_(module, generator)
    return module.to(memory_format=torch.channels_last).eval()


@dataclass
class SDXLModel:
    unet: SDXLUNet
    vae: AutoencoderKL
    # None for the refiner: CLIP-G conditioning only, no text_encoder/
    clip_l: Optional[CLIPTextModel]
    clip_g: CLIPTextModel

    @classmethod
    def create(cls, *, tiny: bool = False, dtype=torch.bfloat16,
               policy: Optional[Policy] = None,
               weight_dtypes: Optional[ModelWeightDtypes] = None,
               device="cuda", generator: Optional[torch.Generator] = None,
               unet_config: Optional[UNetConfig] = None,
               refiner: bool = False,
               init_weights: bool = True) -> "SDXLModel":
        """Bundle on ``device`` (the card unless the caller asks for the
        CPU) with weights drawn from ``generator`` (a CPU generator seeded
        with 0 when None).  ``tiny`` builds the CPU-testable miniature;
        otherwise full SDXL-base width.  ``unet_config`` overrides the
        UNet's (its remat settings, or a variant topology such as
        ``UNetConfig.sdxl_inpainting`` / ``sdxl_refiner``).  ``refiner``
        builds no CLIP-L: prompts go through CLIP-G alone.
        ``init_weights=False`` leaves the weights unset, for a caller that
        loads every tensor from a checkpoint next.

        ``policy`` (``core.types.Policy``), when given, replaces ``dtype``
        with its compute dtype; the UNet computes in its weights' dtype, so
        a policy whose param and compute dtypes differ raises.  CLIP-L and
        CLIP-G follow ``weight_dtypes`` (by default that dtype); the VAE
        is fp32 whatever they say."""
        if tiny:
            ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
            lcfg = CLIPTextConfig.tiny()
            gcfg = CLIPTextConfig.tiny(projection=True)
        else:
            ucfg, vcfg = UNetConfig.sdxl(), VAEConfig.sdxl()
            lcfg, gcfg = CLIPTextConfig.clip_l(), CLIPTextConfig.clip_g()
        if unet_config is not None:
            ucfg = unet_config
        if policy is not None:
            if policy.param_dtype != policy.compute_dtype:
                raise ValueError(
                    f"policy params {policy.param_dtype} with compute "
                    f"{policy.compute_dtype}: the port's UNet computes in "
                    "its weights' dtype")
            dtype = policy.compute_dtype
        wd = weight_dtypes or ModelWeightDtypes.from_single_dtype(
            DataType.from_torch(dtype))
        if not init_weights:
            generator = None
        elif generator is None:
            generator = torch.Generator().manual_seed(0)
        # fp32 products in full fp32: the VAE (and an fp32 UNet and CLIP,
        # mixed_precision "no") run fp32 for accuracy, and cuDNN would
        # otherwise put its fp32 convolutions in TF32 (its default).  16-bit
        # models are unaffected.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.device("meta"):
            parts = (SDXLUNet(ucfg), AutoencoderKL(vcfg),
                     None if refiner else CLIPTextModel(lcfg),
                     CLIPTextModel(gcfg))
        dtypes = (dtype, torch.float32, wd.text_encoder.to_torch(),
                  wd.text_encoder_2.to_torch())
        return cls(*(None if m is None
                     else _materialize(m, dt, device, generator)
                     for m, dt in zip(parts, dtypes)))

    @classmethod
    def from_config(cls, config, *, device="cuda",
                    generator: Optional[torch.Generator] = None
                    ) -> "SDXLModel":
        """The bundle ``config`` (a root ``Config``) asks for, with seeded
        weights, as JAX ``training/loop.py``'s ``_load_model`` builds it:
        ``training.mixed_precision`` through ``Policy.from_mixed_precision``,
        ``tpu.remat`` / ``tpu.remat_policy`` into the UNet's config, the
        miniature where ``model.model_type`` is ``sdxl_tiny``.  The
        training loop's checkpoint import is not ported (ROADMAP queue 1,
        item 12), so a local checkpoint directory in
        ``model.pretrained_model_name`` raises; serving loads one with
        ``SDXLPipeline.from_pretrained``."""
        key = config.model.model_type.strip().lower().replace("-", "_")
        types = ("base", "inpainting", "refiner", "sdxl", "sdxl_tiny")
        if key not in types + ("tiny",):
            raise ValueError(f"Unknown model type: "
                             f"{config.model.model_type!r}. Valid: "
                             f"{list(types)}")
        if Path(config.model.pretrained_model_name).exists():
            raise NotImplementedError(
                f"{config.model.pretrained_model_name}: checkpoint import "
                "into training is not ported yet (ROADMAP queue 1, item "
                "12); from_config builds seeded weights (serving: "
                "SDXLPipeline.from_pretrained)")
        tiny = key in ("sdxl_tiny", "tiny")
        ucfg = (UNetConfig.tiny if tiny else UNetConfig.sdxl)(
            remat=config.tpu.remat, remat_policy=config.tpu.remat_policy)
        return cls.create(
            tiny=tiny,
            policy=Policy.from_mixed_precision(
                config.training.mixed_precision),
            device=device, generator=generator, unet_config=ucfg)

    @property
    def unet_config(self) -> UNetConfig:
        return self.unet.config

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def unet_apply(self, sample, timesteps, prompt_embeds,
                   pooled_prompt_embeds, time_ids, deep_cache=None,
                   return_deep: bool = False):
        return self.unet(sample, timesteps, prompt_embeds,
                         pooled_prompt_embeds, time_ids,
                         deep_cache=deep_cache, return_deep=return_deep)

    def encode_prompt(self, input_ids_l: Optional[torch.Tensor],
                      input_ids_g: torch.Tensor, clip_skip: int = 1):
        """Dual-CLIP encoding: penultimate states concatenated, pooled
        from CLIP-G.  With no CLIP-L (the refiner) CLIP-G alone, and
        ``input_ids_l`` may be None."""
        self._check_token_ids(input_ids_l, input_ids_g)
        if self.clip_l is None:
            return encode_g(self.clip_g, input_ids_g, clip_skip=clip_skip)
        return encode_dual(self.clip_l, self.clip_g, input_ids_l,
                           input_ids_g, clip_skip=clip_skip)

    def _check_token_ids(self, input_ids_l, input_ids_g) -> None:
        """A token id outside the encoder's vocabulary means the tokenizer
        does not match the checkpoint; fail here instead of embedding
        garbage behind finite-looking outputs."""
        for name, ids, enc in (("input_ids_g / tokenizer_2", input_ids_g,
                                self.clip_g),
                               ("input_ids_l / tokenizer", input_ids_l,
                                self.clip_l)):
            if enc is None:
                continue
            mx = int(ids.max())
            if mx >= enc.cfg.vocab_size:
                raise ValueError(
                    f"{name}: token id {mx} >= encoder vocab_size "
                    f"{enc.cfg.vocab_size} - tokenizer/encoder mismatch. "
                    "Use a tokenizer matching the checkpoint, or "
                    "TokenizerPair.fallback(vocab_size=...) matching the "
                    "model.")

    def encode_images(self, pixels: torch.Tensor,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """fp32 pixels [B, 3, H, W] in [-1, 1] -> sampled, scaled latents
        (``AutoencoderKL.encode``; ``noise`` or ``generator`` for the
        sample's draw)."""
        return self.vae.encode(pixels, noise=noise, generator=generator)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, 4, h, w] -> fp32 pixels [B, 3, 8h, 8w]."""
        return self.vae.decode(latents)

    def trainable_params(self) -> Dict[str, torch.nn.Parameter]:
        """The UNet's parameters by name: UNet-only training, as the JAX
        package's ``trainable_params``."""
        return dict(self.unet.named_parameters())
