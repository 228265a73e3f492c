"""SDXL model bundle: UNet + VAE + dual CLIP, in PyTorch.

Port of ``sdxl_training_improvements_tpu/models/sdxl.py``: ``create`` with
seeded weights for all four components, ``unet_apply``, ``encode_prompt``
(dual CLIP -> prompt_embeds [B, 77, 2048] + pooled [B, 1280]) and
``decode_latents``, and ``trainable_params`` (the UNet's parameters: the
training slice trains the UNet only, as JAX does).  Dtypes follow the JAX
package: UNet and CLIP weights in ``dtype`` (bf16 by default), norms'
parameters fp32, the VAE fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from sdxl_training_improvements_tpu_torch.models.clip import (
    CLIPTextConfig, CLIPTextModel, encode_dual)
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
                 generator: torch.Generator) -> nn.Module:
    """Meta-built module -> seeded weights on ``device``: ``dtype`` for
    weights, fp32 for norm parameters, convs' weights channels_last."""
    module = module.to_empty(device=device).to(dtype)
    for m in module.modules():
        if isinstance(m, (GroupNorm, LayerNormF32)):
            m.float()
    _init_(module, generator)
    return module.to(memory_format=torch.channels_last).eval()


@dataclass
class SDXLModel:
    unet: SDXLUNet
    vae: AutoencoderKL
    clip_l: CLIPTextModel
    clip_g: CLIPTextModel

    @classmethod
    def create(cls, *, tiny: bool = False, dtype=torch.bfloat16,
               device="cpu", generator: Optional[torch.Generator] = None,
               unet_config: Optional[UNetConfig] = None) -> "SDXLModel":
        """Bundle with weights drawn from ``generator`` (a CPU generator
        seeded with 0 when None).  ``tiny`` builds the CPU-testable
        miniature; otherwise full SDXL-base width.  ``unet_config``
        overrides the UNet's (e.g. its remat settings)."""
        if tiny:
            ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
            lcfg = CLIPTextConfig.tiny()
            gcfg = CLIPTextConfig.tiny(projection=True)
        else:
            ucfg, vcfg = UNetConfig.sdxl(), VAEConfig.sdxl()
            lcfg, gcfg = CLIPTextConfig.clip_l(), CLIPTextConfig.clip_g()
        if unet_config is not None:
            ucfg = unet_config
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # fp32 products in full fp32: the VAE runs fp32 for accuracy, and
        # cuDNN would otherwise put its fp32 convolutions in TF32 (its
        # default).  The bf16 UNet and CLIP are unaffected.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.device("meta"):
            parts = (SDXLUNet(ucfg), AutoencoderKL(vcfg),
                     CLIPTextModel(lcfg), CLIPTextModel(gcfg))
        dtypes = (dtype, torch.float32, dtype, dtype)
        return cls(*(_materialize(m, dt, device, generator)
                     for m, dt in zip(parts, dtypes)))

    @property
    def unet_config(self) -> UNetConfig:
        return self.unet.config

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def unet_apply(self, sample, timesteps, prompt_embeds,
                   pooled_prompt_embeds, time_ids):
        return self.unet(sample, timesteps, prompt_embeds,
                         pooled_prompt_embeds, time_ids)

    def encode_prompt(self, input_ids_l: torch.Tensor,
                      input_ids_g: torch.Tensor, clip_skip: int = 1):
        """Dual-CLIP encoding: penultimate states concatenated, pooled
        from CLIP-G."""
        self._check_token_ids(input_ids_l, input_ids_g)
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
            mx = int(ids.max())
            if mx >= enc.cfg.vocab_size:
                raise ValueError(
                    f"{name}: token id {mx} >= encoder vocab_size "
                    f"{enc.cfg.vocab_size} - tokenizer/encoder mismatch. "
                    "Use a tokenizer matching the checkpoint, or "
                    "TokenizerPair.fallback(vocab_size=...) matching the "
                    "model.")

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, 4, h, w] -> fp32 pixels [B, 3, 8h, 8w]."""
        return self.vae.decode(latents)

    def trainable_params(self) -> Dict[str, torch.nn.Parameter]:
        """The UNet's parameters by name: UNet-only training, as the JAX
        package's ``trainable_params``."""
        return dict(self.unet.named_parameters())
