"""SDXL UNet in PyTorch.

Port of ``sdxl_training_improvements_tpu/models/unet.py``: the
``UNetConfig`` topology (base, the 9-channel inpainting and the 4-stage
refiner variants, and the mapping to and from a diffusers
``unet/config.json``) and the ``SDXLUNet`` forward.  Activations are NCHW
held as ``channels_last``; attention and the resblock GroupNorm+SiLU go to
the hand-written kernels on the card, forward and backward.

Remat: with ``remat`` (and a gradient being recorded) every resnet and
transformer block runs under ``torch.utils.checkpoint`` (non-reentrant):
JAX's ``nn.remat``.  Under "full" only block inputs are saved and the
backward recomputes each block.  The selective policies (JAX ``:38-109``,
the table at ``:382-508``) run each block under PyTorch's selective
checkpointing, which asks the policy operator by operator, as it
dispatches, whether to keep the output; a kept output is not recomputed.
JAX's primitives map to aten operators:

* ``dot_general`` -> ``aten.mm`` / ``aten.addmm`` (``F.linear``; no batch
  dimensions) and ``aten.bmm`` / ``aten.baddbmm`` (batched);
* ``conv_general_dilated`` -> ``aten.convolution``;
* a ``checkpoint_name`` -> the operator producing the value under the
  name (``models/layers.py``): ``sdxl::gn_silu``, ``aten.convolution``
  or ``sdxl::flash_attn``.

The flash attention is one operator, not a product, so no policy keeps
the S^2 logits: JAX's Pallas flash path keeps none either.  Unlike XLA's
remat, eager recomputation does not skip the operators that only feed a
kept output: a kept convolution is not run again, the GN+SiLU before it
is (unless it is kept too).  ``norm_bf16_arith`` (None: the value of
``remat``) sets ``ops.groupnorm.norm_arith_bf16`` for the forward and for
every recomputation, under every policy, as JAX's ``SDXLUNet.__call__``
sets it for its trace.

The tensor axis: ``place_on_mesh(unet, mesh)`` cuts the transformer
blocks' split leaves (``parallel/mesh.py`` ``tp_plan``) to this rank's
megatron slices and gives their attentions and feed-forwards the mesh's
tensor group (``models/layers.py``); the rest of the UNet runs whole on
every tensor rank.  The fsdp axis under ``tpu.shard_params``: once the
rank stores only its chunks of the large leaves (``parallel/zero.py``
``store_params`` sets ``fsdp``), every unit of ``gather_units`` runs on
its chunks gathered for the call, inside remat's checkpoint for the
blocks, so that the recomputation gathers them again.

DeepCache (arXiv 2312.00858, inference only): ``return_deep=True``
returns the tensor entering the last up stage beside the prediction;
``deep_cache=<that tensor>`` runs only ``conv_in``, down stage 0, the last
up stage and the head around it.  The deep tensor is NCHW
``channels_last`` here and NHWC in JAX.
"""
from __future__ import annotations

import copy
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from sdxl_training_improvements_tpu_torch.models.layers import (
    Attention, Downsample2D, FeedForward, GroupNormSiLU, ResnetBlock2D,
    TimestepEmbedding, Transformer2DModel, Upsample2D,
    current_checkpoint_name, timestep_embedding)
from sdxl_training_improvements_tpu_torch.ops.groupnorm import (
    norm_arith_bf16)

# policy(op, args, name) -> keep the op's output?  ``name`` is the
# checkpoint name the op runs under (None outside one)
Policy = Callable[[object, tuple, Optional[str]], bool]

_aten = torch.ops.aten
NOBATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
BATCHED_DOTS = (_aten.bmm.default, _aten.baddbmm.default)
CONVOLUTIONS = (_aten.convolution.default,)
# the operators that produce a named value (models/layers.py)
NAMED_OPS = (torch.ops.sdxl.gn_silu.default, _aten.convolution.default,
             torch.ops.sdxl.flash_attn.default)


def out_elements(op, args) -> int:
    """Elements of the output of ``op`` from its inputs (the policy runs
    before the op does)."""
    if op is _aten.mm.default:
        return args[0].shape[0] * args[1].shape[1]
    if op is _aten.addmm.default:
        return args[1].shape[0] * args[2].shape[1]
    if op in BATCHED_DOTS:
        a, b = args[-2], args[-1]
        return a.shape[0] * a.shape[1] * b.shape[2]
    if op is _aten.convolution.default:
        x, w = args[0], args[1]
        stride, padding, dilation = args[3], args[4], args[5]
        out = x.shape[0] * w.shape[0]
        for i, size in enumerate(x.shape[2:]):
            k = w.shape[2 + i]
            out *= (size + 2 * padding[i] - dilation[i] * (k - 1) - 1
                    ) // stride[i] + 1
        return out
    return args[0].numel()  # gn_silu, flash_attn: shaped like input 0


def dots_saveable(op, args, name) -> bool:
    """JAX ``dots_saveable``: every product and convolution."""
    return op in NOBATCH_DOTS or op in BATCHED_DOTS or op in CONVOLUTIONS


def dots_with_no_batch_dims_saveable(op, args, name) -> bool:
    """JAX ``dots_with_no_batch_dims_saveable``: products without batch
    dimensions only (``F.linear``'s); never a batched product."""
    return op in NOBATCH_DOTS


def save_only_these_names(*names: str) -> Policy:
    """JAX ``save_only_these_names``."""
    def policy(op, args, name) -> bool:
        return name in names and op in NAMED_OPS
    return policy


def save_from_both_policies(a: Policy, b: Policy) -> Policy:
    """JAX ``save_from_both_policies``."""
    def policy(op, args, name) -> bool:
        return a(op, args, name) or b(op, args, name)
    return policy


def _small_dots_policy(max_out_elements: int = 8 * 1024 * 1024) -> Policy:
    """JAX ``_small_dots_policy``: keep the output of a product without
    batch dimensions when it has at most ``max_out_elements`` elements."""
    def policy(op, args, name) -> bool:
        return op in NOBATCH_DOTS and out_elements(op, args) \
            <= max_out_elements
    return policy


def _small_saves_policy(max_out_elements: int = 8 * 1024 * 1024,
                        small_names: Tuple[str, ...] = (),
                        always_names: Tuple[str, ...] = (),
                        names_max_out_elements: Optional[int] = None,
                        dots: bool = True,
                        name_thresholds: Optional[dict] = None) -> Policy:
    """JAX ``_small_saves_policy``: small products as
    ``_small_dots_policy`` (unless ``dots`` is False), and named values
    by their element count: under ``name_thresholds[name]``, else under
    ``names_max_out_elements`` (default ``max_out_elements``) for a name
    in ``small_names``; a name in ``always_names`` always."""
    dots_policy = _small_dots_policy(max_out_elements) if dots else None
    names_max = names_max_out_elements or max_out_elements

    def policy(op, args, name) -> bool:
        if name is not None and op in NAMED_OPS:
            if name in always_names:
                return True
            cap = (name_thresholds or {}).get(
                name, names_max if name in small_names else None)
            return cap is not None and out_elements(op, args) <= cap
        return dots_policy is not None and dots_policy(op, args, name)
    return policy


_CONV_NAMES = ("res_conv", "gn_silu", "attn_core")
_MIB = 1024 * 1024


def remat_policy_table() -> Dict[str, Optional[Policy]]:
    """JAX ``SDXLUNet._blocks``' table: name -> the policy of every
    remat'd block (None: full remat).  Each entry's reason is at JAX
    ``models/unet.py:382-461``."""
    return {
        "full": None,
        "dots": dots_saveable,
        "dots_nobatch": dots_with_no_batch_dims_saveable,
        "dots_small": _small_dots_policy(),
        "dots_small_attn": save_from_both_policies(
            _small_dots_policy(), save_only_these_names("attn_core")),
        "dots_small_conv": _small_saves_policy(small_names=_CONV_NAMES),
        "dots_small_conv_wide": _small_saves_policy(
            small_names=_CONV_NAMES, names_max_out_elements=12 * _MIB),
        "dots_small_conv_mid": _small_saves_policy(small_names=_CONV_NAMES),
        "dots_small_conv_attnwide": _small_saves_policy(
            small_names=_CONV_NAMES,
            name_thresholds={"attn_core": 12 * _MIB}),
        "dots_small_conv10": _small_saves_policy(
            max_out_elements=10 * _MIB + 512 * 1024,
            small_names=_CONV_NAMES),
        "dots_small_conv10_128": _small_saves_policy(
            max_out_elements=10 * _MIB + 512 * 1024,
            small_names=_CONV_NAMES,
            name_thresholds={"res_conv": 22 * _MIB, "gn_silu": 22 * _MIB}),
    }


def remat_policies(name: str) -> Tuple[Optional[Policy], Optional[Policy]]:
    """(policy of every block, policy of the mid block's transformer) for
    ``remat_policy`` ``name``, with JAX's mid-block rules (``:471-507``);
    an unknown name raises ``ValueError`` listing the policies."""
    table = remat_policy_table()
    if name not in table:
        raise ValueError(f"Unknown remat_policy {name!r}; "
                         f"one of {sorted(table)}")
    policy = mid = table[name]
    if name == "dots_small_attn":
        mid = save_only_these_names("attn_core")
    if name in ("dots_small_conv_wide", "dots_small_conv_mid"):
        mid = _small_saves_policy(
            small_names=_CONV_NAMES,
            names_max_out_elements=(12 * _MIB
                                    if name == "dots_small_conv_wide"
                                    else None),
            dots=False)
    if name in ("dots_small", "dots_small_conv", "dots_small_conv_attnwide",
                "dots_small_conv10", "dots_small_conv10_128"):
        mid = None
    return policy, mid


def selective_checkpoint_context(policy: Policy):
    """``context_fn`` for ``torch.utils.checkpoint``: keep what
    ``policy`` keeps, with the current checkpoint name."""
    def sac(ctx, op, *args, **kwargs):
        keep = policy(op, args, current_checkpoint_name())
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(sac)


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
    # a name of remat_policy_table(): "full" or a selective dots* policy
    remat_policy: str = "full"
    # bf16 norm interior; None = on iff remat (JAX unet.py:519-522)
    norm_bf16_arith: Optional[bool] = None

    def __post_init__(self):
        if self.remat:
            remat_policies(self.remat_policy)  # an unknown name raises

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
        # (every block's policy, the mid transformer's); a test may set
        # policies of its own here
        self.remat_policies = (remat_policies(cfg.remat_policy)
                               if cfg.remat else (None, None))
        # the fsdp layout (parallel/zero.py Zero) once the parameters are
        # stored as chunks: each unit gathers its own to run
        self.fsdp = None

    def gather_units(self):
        """(name, module) of each unit whose chunked parameters are
        gathered together (``parallel/zero.py`` ``store_params``): every
        resnet and transformer block (remat's units), every resampler,
        the stem, the time and add embeddings and the output head."""
        kinds = (ResnetBlock2D, Transformer2DModel, Downsample2D,
                 Upsample2D)
        return [(n, m) for n, m in self.named_modules()
                if isinstance(m, kinds) or n in (
                    "conv_in", "time_embedding", "add_embedding",
                    "conv_norm_out", "conv_out")]

    def _run(self, module, *args, recomputed: bool = False):
        """``module(*args)``; with stored fsdp chunks, on its gathered
        parameters (``recomputed``: under remat's checkpoint)."""
        if self.fsdp is None:
            return module(*args)
        return self.fsdp.run_unit(module, *args, recomputed=recomputed)

    def _block(self, block, *args, mid: bool = False):
        """Run one resnet or transformer block, under the remat policy
        when a gradient is being recorded (``mid``: the mid block's
        transformer, which has its own policy)."""
        if self.config.remat and torch.is_grad_enabled():
            policy = self.remat_policies[1 if mid else 0]
            kw = {} if policy is None else {"context_fn": functools.partial(
                selective_checkpoint_context, policy)}
            return checkpoint(self._recomputable, block, *args,
                              use_reentrant=False, **kw)
        return self._run(block, *args)

    def _recomputable(self, block, *args):
        # the recomputation runs in the backward, outside forward()'s
        # context (on the card, on autograd's own thread): set it again
        with norm_arith_bf16(self.config.norm_bf16):
            return self._run(block, *args, recomputed=True)

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
        emb = self._run(self.time_embedding, t_emb.to(dt))
        ids_emb = timestep_embedding(time_ids.reshape(-1),
                                     cfg.addition_time_embed_dim)
        add_in = torch.cat([text_embeds.float(),
                            ids_emb.reshape(x.shape[0], -1)], dim=-1)
        emb = emb + self._run(self.add_embedding, add_in.to(dt))
        ctx = encoder_hidden_states.to(dt)

        shallow = deep_cache is not None
        x = self._run(self.conv_in, x)
        skips = [x]
        for block in self.down_blocks[:1] if shallow else self.down_blocks:
            attns = getattr(block, "attentions", None)
            for j, res in enumerate(block.resnets):
                x = self._block(res, x, emb)
                if attns is not None:
                    x = self._block(attns[j], x, ctx)
                skips.append(x)
            if hasattr(block, "downsamplers") and not shallow:
                x = self._run(block.downsamplers[0], x)
                skips.append(x)

        if shallow:
            x = deep_cache.to(dt).contiguous(
                memory_format=torch.channels_last)
        else:
            mid = self.mid_block
            x = self._block(mid.resnets[0], x, emb)
            if hasattr(mid, "attentions"):
                x = self._block(mid.attentions[0], x, ctx, mid=True)
            x = self._block(mid.resnets[1], x, emb)
            for block in self.up_blocks[:-1]:
                x = self._up_block(block, x, skips, emb, ctx)
        deep = x
        x = self._up_block(self.up_blocks[-1], x, skips, emb, ctx)
        out = self._run(self.conv_out,
                        self._run(self.conv_norm_out, x))
        return (out, deep) if return_deep else out

    def _up_block(self, block, x, skips, emb, ctx):
        attns = getattr(block, "attentions", None)
        for j, res in enumerate(block.resnets):
            x = self._block(res, torch.cat([x, skips.pop()], dim=1), emb)
            if attns is not None:
                x = self._block(attns[j], x, ctx)
        if hasattr(block, "upsamplers"):
            x = self._run(block.upsamplers[0], x)
        return x


def attention_heads(unet: nn.Module) -> Dict[str, int]:
    """Each attention module's head count, by module name."""
    return {n: m.num_heads for n, m in unet.named_modules()
            if isinstance(m, Attention)}


def place_on_mesh(unet: nn.Module, mesh, copy_module: bool = False):
    """Put ``unet`` (whole) on the mesh's tensor axis: each leaf that
    ``parallel/mesh.py`` ``tp_plan`` splits becomes this rank's slice (the
    parameter's data replaced, so a dict of the parameters sees it), and
    each split attention and feed-forward gets the tensor group.  Returns
    (the module, the plan).  ``copy_module``: place a copy, which shares
    every unsplit parameter and buffer with ``unet`` (serving: the
    caller's UNet stays whole).  A tensor axis of 1 splits nothing."""
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    from sdxl_training_improvements_tpu_torch.parallel.tensor import (
        maybe_group)
    params = dict(unet.named_parameters())
    plan = M.tp_plan(params, mesh, attention_heads(unet))
    if copy_module:
        memo = {id(t): t for n, t in params.items() if n not in plan}
        memo[id(unet.fsdp)] = None  # the copy gathers nothing
        memo.update({id(b): b for b in unet.buffers()})
        memo.update({id(params[n]): nn.Parameter(
            s.cut(params[n].detach()), requires_grad=params[n].requires_grad)
            for n, s in plan.items()})
        unet = copy.deepcopy(unet, memo)
    else:
        with torch.no_grad():
            for n, s in plan.items():
                params[n].data = s.cut(params[n].data)
    group = maybe_group(mesh)
    for name, m in unet.named_modules():
        if isinstance(m, (Attention, FeedForward)):
            first = next(n for n, _ in m.named_parameters())
            m.tp_group = group if f"{name}.{first}" in plan else None
    return unet, plan
