"""AutoencoderKL (the SDXL VAE) in PyTorch, fp32.

Port of ``sdxl_training_improvements_tpu/models/vae.py``.  Encoder and
decoder: ``encode`` (sampled, scaled latents, for img2img and inpainting)
and ``decode``.  Every resnet's GroupNorm+SiLU goes through the kernel on
the card; the mid-block attention (single head) is a plain matmul +
softmax, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sdxl_training_improvements_tpu_torch.models.layers import (
    GroupNorm, ResnetBlock2D, Upsample2D, _nchw, _nhwc)

SDXL_VAE_SCALING_FACTOR = 0.13025


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = SDXL_VAE_SCALING_FACTOR

    @classmethod
    def sdxl(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1,
                   norm_num_groups=8)

    @property
    def downscale_factor(self) -> int:
        """Pixel->latent spatial factor (8 for SDXL's 4-stage encoder)."""
        return 2 ** (len(self.block_out_channels) - 1)


class VAEAttention(nn.Module):
    """Single-head spatial self-attention with GroupNorm and residual."""

    def __init__(self, channels: int, num_groups: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, num_groups, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        hx = _nhwc(self.group_norm(x)).reshape(b, h * w, c)
        q, k, v = self.to_q(hx), self.to_k(hx), self.to_v(hx)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) \
            * c ** -0.5
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        out = self.to_out[0](out)
        return x + _nchw(out.reshape(b, h, w, c))


class _Downsample(nn.Module):
    """Stride-2 conv with the VAE's asymmetric (0,1)x(0,1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Stage(nn.Module):
    def __init__(self, resnets, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class _Mid(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(channels, channels, None, groups, 1e-6)
             for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g, chs = cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chs[0]
        for i, ch in enumerate(chs):
            self.down_blocks.append(_Stage(
                [ResnetBlock2D(prev if j == 0 else ch, ch, None, g, 1e-6)
                 for j in range(cfg.layers_per_block)],
                downsample=_Downsample(ch) if i < len(chs) - 1 else None))
            prev = ch
        self.mid_block = _Mid(chs[-1], g)
        self.conv_norm_out = GroupNorm(chs[-1], g, 1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks:
            for res in stage.resnets:
                x = res(x)
            if hasattr(stage, "downsamplers"):
                x = stage.downsamplers[0](x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0], g)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, ch in enumerate(rev):
            self.up_blocks.append(_Stage(
                [ResnetBlock2D(prev if j == 0 else ch, ch, None, g, 1e-6)
                 for j in range(cfg.layers_per_block + 1)],
                upsample=Upsample2D(ch) if i < len(rev) - 1 else None))
            prev = ch
        self.conv_norm_out = GroupNorm(rev[-1], g, 1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for stage in self.up_blocks:
            for res in stage.resnets:
                x = res(x)
            if hasattr(stage, "upsamplers"):
                x = stage.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """Encoder + quant convs + decoder."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = VAEEncoder(config)
        self.decoder = VAEDecoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def moments(self, pixels: torch.Tensor):
        """[B, 3, H, W] in [-1, 1] -> (mean, logvar), each [B, 4, H/8, W/8]."""
        x = pixels.to(self.conv_dtype).contiguous(
            memory_format=torch.channels_last)
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, pixels: torch.Tensor, sample: bool = True,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, 3, H, W] in [-1, 1] -> scaled latents ``(mean + exp(0.5 *
        logvar) * n) * scaling_factor`` (``mean * scaling_factor`` without
        ``sample``), JAX ``vae.py:196-203``.  ``n`` is ``noise`` when given,
        else N(0, 1) drawn from ``generator`` on the latents' device."""
        mean, logvar = self.moments(pixels)
        if sample:
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator,
                                    device=mean.device, dtype=mean.dtype)
            elif tuple(noise.shape) != tuple(mean.shape):
                raise ValueError(f"noise shape {tuple(noise.shape)} != "
                                 f"latents {tuple(mean.shape)}")
            mean = mean + torch.exp(0.5 * logvar) * noise.to(mean)
        return mean * self.config.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, 4, h, w] -> pixels [B, 3, 8h, 8w]."""
        z = (latents / self.config.scaling_factor).to(self.conv_dtype)
        z = z.contiguous(memory_format=torch.channels_last)
        return self.decoder(self.post_quant_conv(z))

    @property
    def conv_dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype
