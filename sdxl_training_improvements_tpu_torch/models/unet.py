"""SDXL UNet in PyTorch.

Port of ``sdxl_training_improvements_tpu/models/unet.py``: the
``UNetConfig`` topology (base, the 9-channel inpainting and the 4-stage
refiner variants, and the mapping to and from a diffusers
``unet/config.json``) and the ``SDXLUNet`` forward.  Activations are NCHW
held as ``channels_last``; attention and the resblock GroupNorm+SiLU go to
the hand-written kernels on the card, forward and backward.

Remat: with ``remat`` (and a gradient being recorded) every resnet and
transformer block runs under ``torch.utils.checkpoint`` (non-reentrant), so
only block inputs are saved and the backward recomputes each block: JAX's
``nn.remat`` with the "full" policy.  The selective policies (``dots*``)
are not ported.  ``norm_bf16_arith`` (None: the value of ``remat``) sets
``ops.groupnorm.norm_arith_bf16`` for the forward and for every
recomputation, as JAX's ``SDXLUNet.__call__`` sets it for its trace.

DeepCache (arXiv 2312.00858, inference only): ``return_deep=True``
returns the tensor entering the last up stage beside the prediction;
``deep_cache=<that tensor>`` runs only ``conv_in``, down stage 0, the last
up stage and the head around it.  The deep tensor is NCHW
``channels_last`` here and NHWC in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sdxl_training_improvements_tpu_torch.models.layers import (
    Downsample2D, GroupNormSiLU, ResnetBlock2D, TimestepEmbedding,
    Transformer2DModel, Upsample2D, timestep_embedding)
from sdxl_training_improvements_tpu_torch.ops.groupnorm import (
    norm_arith_bf16)


@dataclass(frozen=True)
class UNetConfig:
    """Architecture hyperparameters; ``sdxl()`` is SDXL-base."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    # transformer depth per stage; 0 = plain resnet stage
    transformer_layers_per_block: Tuple[int, ...] = (0, 2, 10)
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    addition_time_embed_dim: int = 256
    # pooled text (1280) + 6 time-ids * 256 = 2816 for SDXL
    projection_class_embeddings_input_dim: int = 2816
    num_time_ids: int = 6
    # transformer depth of the mid block; None = the last stage's depth
    mid_block_transformer_layers: Optional[int] = None
    norm_num_groups: int = 32
    # recompute each resnet/transformer block in the backward
    remat: bool = True
    # only "full" is ported; the JAX package's selective dots* policies
    # are in ROADMAP queue 1
    remat_policy: str = "full"
    # bf16 norm interior; None = on iff remat (JAX unet.py:519-522)
    norm_bf16_arith: Optional[bool] = None

    def __post_init__(self):
        if self.remat and self.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r} is not ported; only "
                "'full' (ROADMAP queue 1, the selective remat policies)")

    @classmethod
    def sdxl(cls, **kw) -> "UNetConfig":
        return cls(**kw)

    @classmethod
    def sdxl_inpainting(cls, **kw) -> "UNetConfig":
        """SDXL-base with the 9-channel inpainting input: [noisy latents
        (4), mask (1), masked-image latents (4)], the layout of
        ``diffusers/stable-diffusion-xl-1.0-inpainting-0.1``.  Only
        ``conv_in`` differs from base."""
        kw.setdefault("in_channels", 9)
        return cls(**kw)

    @classmethod
    def sdxl_refiner(cls, **kw) -> "UNetConfig":
        """SDXL-refiner-1.0: 4 stages (384, 768, 1536, 1536), cross
        attention of depth 4 (dim 1280, CLIP-G only) in the middle two
        stages and the mid block, plain first and last stages, and 5 time
        ids (the aesthetic score replaces the target size).  A checkpoint's
        ``unet/config.json`` (``from_diffusers_config``) overrides it."""
        defaults = dict(
            block_out_channels=(384, 768, 1536, 1536),
            transformer_layers_per_block=(0, 4, 4, 0),
            mid_block_transformer_layers=4,
            cross_attention_dim=1280,
            # pooled CLIP-G 1280 + 5 ids * 256
            projection_class_embeddings_input_dim=2560,
            num_time_ids=5,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def from_diffusers_config(cls, cfg: dict, **overrides) -> "UNetConfig":
        """From a diffusers ``unet/config.json`` dict, with the JAX
        package's rules (``models/unet.py:194``): ``down_block_types``
        decides which stages attend and ``transformer_layers_per_block``
        their depth; the mid block takes the last entry's depth even
        after a plain stage; a per-stage ``attention_head_dim`` is the
        SDXL family's head COUNT (the head dim is channels / heads);
        ``num_time_ids`` follows from ``projection_class_embeddings_
        input_dim`` = pooled + ids * ``addition_time_embed_dim`` (pooled
        1280 unless the ``_pooled_embed_dim`` extension key says
        otherwise).  An unsupported conditioning mode raises."""
        def req(key, want):
            got = cfg.get(key, want)
            if got != want and not (want is None and got is None):
                raise ValueError(
                    f"unsupported diffusers UNet config: {key}={got!r} "
                    f"(supported: {want!r})")

        req("addition_embed_type", "text_time")
        req("class_embed_type", None)
        req("encoder_hid_dim", None)
        req("dual_cross_attention", False)
        req("mid_block_type", "UNetMidBlock2DCrossAttn")
        if isinstance(cfg.get("layers_per_block", 2), (list, tuple)):
            raise ValueError("per-stage layers_per_block unsupported")

        channels = tuple(cfg["block_out_channels"])
        n = len(channels)
        down_types = cfg.get("down_block_types",
                             ("DownBlock2D",) + ("CrossAttnDownBlock2D",)
                             * (n - 1))
        if len(down_types) != n:
            raise ValueError("down_block_types length != block_out_channels")
        for t in down_types:
            if t not in ("DownBlock2D", "CrossAttnDownBlock2D"):
                raise ValueError(f"unsupported down block type {t!r}")
        tfm = cfg.get("transformer_layers_per_block", 1)
        tfm_list = list(tfm) if isinstance(tfm, (list, tuple)) else [tfm] * n
        if len(tfm_list) != n:
            raise ValueError(
                "transformer_layers_per_block length != block_out_channels")
        depths = tuple(
            tfm_list[i] if down_types[i] == "CrossAttnDownBlock2D" else 0
            for i in range(n))

        head_dim = cfg.get("attention_head_dim", 64)
        if isinstance(head_dim, (list, tuple)):
            dims = {channels[i] // head_dim[i]
                    for i in range(n) if depths[i] > 0}
            if len(dims) != 1:
                raise ValueError(
                    f"non-constant head dim {sorted(dims)} from "
                    f"attention_head_dim={head_dim}; unsupported")
            head_dim = dims.pop()

        add_dim = cfg.get("addition_time_embed_dim", 256)
        proj = cfg["projection_class_embeddings_input_dim"]
        pooled = cfg.get("_pooled_embed_dim", 1280)
        if (proj - pooled) % add_dim or proj <= pooled:
            raise ValueError(
                f"cannot derive num_time_ids from projection dim {proj} "
                f"(pooled {pooled}, addition_time_embed_dim {add_dim})")

        kw = dict(
            in_channels=cfg.get("in_channels", 4),
            out_channels=cfg.get("out_channels", 4),
            block_out_channels=channels,
            layers_per_block=cfg.get("layers_per_block", 2),
            transformer_layers_per_block=depths,
            mid_block_transformer_layers=tfm_list[-1],
            attention_head_dim=head_dim,
            cross_attention_dim=cfg.get("cross_attention_dim", 1280),
            addition_time_embed_dim=add_dim,
            projection_class_embeddings_input_dim=proj,
            num_time_ids=(proj - pooled) // add_dim,
            norm_num_groups=cfg.get("norm_num_groups", 32),
        )
        kw.update(overrides)
        return cls(**kw)

    def to_diffusers_config(self) -> dict:
        """The diffusers ``unet/config.json`` of this topology, the inverse
        of ``from_diffusers_config`` (JAX ``models/unet.py:290``): per-stage
        head COUNTS in ``attention_head_dim`` (plain stages get a
        placeholder), the mid depth in the last depth slot, and the
        ``_pooled_embed_dim`` extension key (diffusers ignores underscore
        keys)."""
        down_types = ["CrossAttnDownBlock2D" if d > 0 else "DownBlock2D"
                      for d in self.transformer_layers_per_block]
        head_counts = [max(1, c // self.attention_head_dim)
                       for c in self.block_out_channels]
        tfm = [d if d > 0 else self.mid_depth
               for d in self.transformer_layers_per_block]
        last = self.transformer_layers_per_block[-1]
        if last > 0 and last != self.mid_depth:
            raise ValueError(
                "diffusers cannot represent an attending last down stage "
                f"(depth {last}) with a different mid-block depth "
                f"({self.mid_depth}): both read "
                "transformer_layers_per_block[-1]")
        tfm[-1] = self.mid_depth
        return {
            "_class_name": "UNet2DConditionModel",
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "block_out_channels": list(self.block_out_channels),
            "down_block_types": down_types,
            "up_block_types": ["UpBlock2D" if d == 0 else "CrossAttnUpBlock2D"
                               for d in reversed(
                                   self.transformer_layers_per_block)],
            "layers_per_block": self.layers_per_block,
            "transformer_layers_per_block": tfm,
            "attention_head_dim": head_counts,
            "cross_attention_dim": self.cross_attention_dim,
            "addition_embed_type": "text_time",
            "addition_time_embed_dim": self.addition_time_embed_dim,
            "projection_class_embeddings_input_dim":
                self.projection_class_embeddings_input_dim,
            "norm_num_groups": self.norm_num_groups,
            "mid_block_type": "UNetMidBlock2DCrossAttn",
            "sample_size": 128,
            "_pooled_embed_dim": self.pooled_embed_dim,
        }

    @classmethod
    def tiny(cls, **kw) -> "UNetConfig":
        """CPU-testable miniature with the same topology."""
        defaults = dict(
            block_out_channels=(32, 64, 128),
            layers_per_block=1,
            transformer_layers_per_block=(0, 1, 1),
            attention_head_dim=16,
            cross_attention_dim=64,
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=32 + 6 * 8,
            remat=False,
        )
        defaults.update(kw)
        return cls(**defaults)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def pooled_embed_dim(self) -> int:
        return (self.projection_class_embeddings_input_dim
                - self.num_time_ids * self.addition_time_embed_dim)

    @property
    def mid_depth(self) -> int:
        if self.mid_block_transformer_layers is not None:
            return self.mid_block_transformer_layers
        return self.transformer_layers_per_block[-1]

    @property
    def norm_bf16(self) -> bool:
        """Whether the plain norms keep a bf16 interior for bf16 inputs."""
        return (self.remat if self.norm_bf16_arith is None
                else self.norm_bf16_arith)


class _Block(nn.Module):
    """A down, mid or up block: resnets, optional attentions and an
    optional resampler, under diffusers' names."""

    def __init__(self, resnets, attentions=None, downsample=None,
                 upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class SDXLUNet(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        b0, ted, g = cfg.block_out_channels[0], cfg.time_embed_dim, \
            cfg.norm_num_groups

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, ted, g)

        def tfm(ch, depth):
            return Transformer2DModel(ch, cfg.cross_attention_dim,
                                      ch // cfg.attention_head_dim,
                                      cfg.attention_head_dim, depth)

        self.conv_in = nn.Conv2d(cfg.in_channels, b0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(b0, ted)
        self.add_embedding = TimestepEmbedding(
            cfg.projection_class_embeddings_input_dim, ted)

        n = len(cfg.block_out_channels)
        skips, prev = [b0], b0
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(cfg.block_out_channels):
            depth = cfg.transformer_layers_per_block[i]
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(resnet(prev if j == 0 else ch, ch))
                if depth > 0:
                    attns.append(tfm(ch, depth))
                skips.append(ch)
            down = Downsample2D(ch) if i < n - 1 else None
            if down is not None:
                skips.append(ch)
            self.down_blocks.append(_Block(resnets, attns, downsample=down))
            prev = ch

        mid = cfg.block_out_channels[-1]
        self.mid_block = _Block(
            [resnet(mid, mid), resnet(mid, mid)],
            [tfm(mid, cfg.mid_depth)] if cfg.mid_depth > 0 else None)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(cfg.block_out_channels))
        rev_depth = list(reversed(cfg.transformer_layers_per_block))
        for i, ch in enumerate(rev):
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(resnet((prev if j == 0 else ch) + skips.pop(),
                                      ch))
                if rev_depth[i] > 0:
                    attns.append(tfm(ch, rev_depth[i]))
            up = Upsample2D(ch) if i < n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, upsample=up))
            prev = ch

        self.conv_norm_out = GroupNormSiLU(b0, g, 1e-5)
        self.conv_out = nn.Conv2d(b0, cfg.out_channels, 3, padding=1)

    def _block(self, block, *args):
        """Run one resnet or transformer block, under the full remat
        policy when a gradient is being recorded."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(self._recomputable, block, *args,
                              use_reentrant=False)
        return block(*args)

    def _recomputable(self, block, *args):
        # the recomputation runs in the backward, outside forward()'s
        # context (on the card, on autograd's own thread): set it again
        with norm_arith_bf16(self.config.norm_bf16):
            return block(*args)

    def forward(self, sample, timesteps, encoder_hidden_states, text_embeds,
                time_ids, deep_cache=None, return_deep: bool = False):
        """sample [B, C, H, W] latents; timesteps [B] (or a scalar; floats
        in [0, 1] for flow matching); encoder_hidden_states [B, 77,
        cross_attention_dim]; text_embeds [B, pooled_dim]; time_ids [B,
        num_time_ids].  Returns the [B, C, H, W] prediction in the weights'
        dtype, and with ``return_deep`` the deep feature beside it (the
        DeepCache split, module docstring)."""
        if deep_cache is not None and (len(self.config.block_out_channels)
                                       < 2 or return_deep):
            raise ValueError("deep_cache needs >=2 stages and excludes "
                             "return_deep")
        with norm_arith_bf16(self.config.norm_bf16):
            return self._forward(sample, timesteps, encoder_hidden_states,
                                 text_embeds, time_ids, deep_cache,
                                 return_deep)

    def _forward(self, sample, timesteps, encoder_hidden_states, text_embeds,
                 time_ids, deep_cache, return_deep):
        cfg = self.config
        dt = self.conv_in.weight.dtype
        x = sample.to(dt).contiguous(memory_format=torch.channels_last)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(x.shape[0])

        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        emb = self.time_embedding(t_emb.to(dt))
        ids_emb = timestep_embedding(time_ids.reshape(-1),
                                     cfg.addition_time_embed_dim)
        add_in = torch.cat([text_embeds.float(),
                            ids_emb.reshape(x.shape[0], -1)], dim=-1)
        emb = emb + self.add_embedding(add_in.to(dt))
        ctx = encoder_hidden_states.to(dt)

        shallow = deep_cache is not None
        x = self.conv_in(x)
        skips = [x]
        for block in self.down_blocks[:1] if shallow else self.down_blocks:
            attns = getattr(block, "attentions", None)
            for j, res in enumerate(block.resnets):
                x = self._block(res, x, emb)
                if attns is not None:
                    x = self._block(attns[j], x, ctx)
                skips.append(x)
            if hasattr(block, "downsamplers") and not shallow:
                x = block.downsamplers[0](x)
                skips.append(x)

        if shallow:
            x = deep_cache.to(dt).contiguous(
                memory_format=torch.channels_last)
        else:
            mid = self.mid_block
            x = self._block(mid.resnets[0], x, emb)
            if hasattr(mid, "attentions"):
                x = self._block(mid.attentions[0], x, ctx)
            x = self._block(mid.resnets[1], x, emb)
            for block in self.up_blocks[:-1]:
                x = self._up_block(block, x, skips, emb, ctx)
        deep = x
        x = self._up_block(self.up_blocks[-1], x, skips, emb, ctx)
        out = self.conv_out(self.conv_norm_out(x))
        return (out, deep) if return_deep else out

    def _up_block(self, block, x, skips, emb, ctx):
        attns = getattr(block, "attentions", None)
        for j, res in enumerate(block.resnets):
            x = self._block(res, torch.cat([x, skips.pop()], dim=1), emb)
            if attns is not None:
                x = self._block(attns[j], x, ctx)
        if hasattr(block, "upsamplers"):
            x = block.upsamplers[0](x)
        return x
