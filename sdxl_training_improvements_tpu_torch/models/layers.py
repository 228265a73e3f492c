"""Building blocks of the SDXL UNet and VAE, in PyTorch.

Port of ``sdxl_training_improvements_tpu/models/layers.py``.  Spatial
tensors are NCHW held as ``channels_last`` (NHWC in memory), so a
GroupNorm site reads a contiguous [B, S, C] view without a copy and the
convolutions run in the NHWC layout.  Norms keep fp32 parameters and fp32
statistics and return the input dtype; projections and convolutions run in
the weights' dtype (bf16 for the UNet, fp32 for the VAE).

Parameter names follow diffusers (``conv1``, ``time_emb_proj``, ``attn1``,
``ff.net.0.proj``, ``to_out.0`` ...), so a diffusers state dict, or one
converted from the JAX package (``models/weights.py``), loads strictly.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sdxl_training_improvements_tpu_torch.ops.attention import (
    dot_product_attention)
from sdxl_training_improvements_tpu_torch.ops.groupnorm import (
    group_norm_bf16, group_norm_f32, groupnorm_silu, norm_arith_bf16_enabled,
    normalize_bf16)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, fp32 (SDXL: flip_sin_to_cos, no
    shift): exponent = -ln(P) * arange(half) / (half - shift)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2 (diffusers ``TimestepEmbedding``)."""

    def __init__(self, in_dim: int, emb_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, emb_dim)
        self.linear_2 = nn.Linear(emb_dim, emb_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channels-last [B, ..., C]: fp32 statistics, output in
    the input dtype.  The interior is fp32, or bf16 for a bf16 input under
    ``norm_arith_bf16`` (the remat policy, JAX ``layers.py:65-106``).
    Plain everywhere: the JAX package runs this norm outside its Pallas
    kernel too."""
    if x.dtype == torch.bfloat16 and norm_arith_bf16_enabled():
        return group_norm_bf16(x, scale, bias, num_groups, eps)
    return group_norm_f32(x, scale, bias, num_groups, eps).to(x.dtype)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class GroupNorm(nn.Module):
    """GroupNorm on NCHW (channels_last) input; fp32 parameters."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return _nchw(group_norm(_nhwc(x), self.weight, self.bias,
                                self.num_groups, self.eps))


class GroupNormSiLU(GroupNorm):
    """GroupNorm fused with SiLU: the CUDA kernels on the card
    (``ops/groupnorm.py``).  Parameter names match plain GroupNorm."""

    def forward(self, x):
        return _nchw(groupnorm_silu(_nhwc(x), self.weight, self.bias,
                                    self.num_groups, self.eps))


class ResnetBlock2D(nn.Module):
    """GN->SiLU->conv3x3 -> +time-emb -> GN->SiLU->conv3x3 -> +skip."""

    def __init__(self, in_channels: int, out_channels: int,
                 emb_dim: Optional[int] = None, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels, num_groups, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if emb_dim is not None:
            self.time_emb_proj = nn.Linear(emb_dim, out_channels)
        self.norm2 = GroupNormSiLU(out_channels, num_groups, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, emb=None):
        h = self.conv1(self.norm1(x))
        if emb is not None:
            h = h + self.time_emb_proj(F.silu(emb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention, self when ``context`` is None, else cross.
    q/k/v projections have no bias, the output projection has one."""

    def __init__(self, dim: int, context_dim: int, num_heads: int,
                 head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, s, _ = x.shape
        t = ctx.shape[1]
        q = self.to_q(x).view(b, s, self.num_heads, self.head_dim)
        k = self.to_k(ctx).view(b, t, self.num_heads, self.head_dim)
        v = self.to_v(ctx).view(b, t, self.num_heads, self.head_dim)
        out = dot_product_attention(q, k, v)
        return self.to_out[0](out.reshape(b, s, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner_dim * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # exact (erf) GELU in fp32, as diffusers' GEGLU and the JAX port
        return h * F.gelu(gate.float()).to(h.dtype)


class FeedForward(nn.Module):
    """GEGLU -> Linear; index 1 is diffusers' parameter-free dropout."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class LayerNormF32(nn.Module):
    """LayerNorm with fp32 parameters and statistics, output in the input
    dtype.  Same interior policy as ``group_norm``: bf16 inputs under
    ``norm_arith_bf16`` normalize in bf16 after single-pass fp32
    statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        if x.dtype == torch.bfloat16 and norm_arith_bf16_enabled():
            return (normalize_bf16(x, (-1,), self.eps)
                    * self.weight.to(x.dtype) + self.bias.to(x.dtype))
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class BasicTransformerBlock(nn.Module):
    """LN->self-attn, LN->cross-attn, LN->FF, each residual."""

    def __init__(self, dim: int, context_dim: int, num_heads: int,
                 head_dim: int):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn1 = Attention(dim, dim, num_heads, head_dim)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = Attention(dim, context_dim, num_heads, head_dim)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm (eps 1e-6) -> linear proj_in -> blocks -> proj_out ->
    +residual (the use_linear_projection variant SDXL uses)."""

    def __init__(self, channels: int, context_dim: int, num_heads: int,
                 head_dim: int, depth: int):
        super().__init__()
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, num_heads,
                                   head_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        hx = _nhwc(self.norm(x)).reshape(b, h * w, c)
        hx = self.proj_in(hx)
        for block in self.transformer_blocks:
            hx = block(hx, context)
        hx = self.proj_out(hx)
        return _nchw(hx.reshape(b, h, w, c)) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
