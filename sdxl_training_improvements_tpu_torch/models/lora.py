"""LoRA adapters on a frozen UNet.

Port of ``sdxl_training_improvements_tpu/models/lora.py``: one low-rank
pair per targeted Linear or Conv2d weight, ``W' = W + alpha * up @ down``,
with down ~ N(0, 1/r) and up = 0, so training starts at the base model.
The trainable tree is the pairs only; the base stays frozen.

Selection.  ``training.lora.targets`` are regexes over the JAX package's
flax parameter paths (``DEFAULT_TARGETS`` matches ``attn1/to_q`` ...), and
the config is shared, so each port weight is matched through its JAX path
(``jax_path``: the inverse of ``models/weights.py``'s key map, checked
against it): the same regex selects the same kernels in both packages.

Layouts.  The tree is a flat dict keyed ``<module>.down`` /
``<module>.up`` by the port's module names, in torch's layout (peft's
``lora_A`` / ``lora_B``): a Linear's down ``[r, in]`` and up ``[out, r]``;
a convolution's down ``[r, in, kh, kw]`` (a rank-r conv with the module's
own geometry) and up ``[out, r]`` (the 1x1 mix).  ``models/weights.py``
``from_jax_lora`` maps JAX's ``[in, r]`` / ``[kh, kw, in, r]`` / ``[r, out]``
onto it.

Two paths, as in JAX (``lora_train_wrappers``):

* merge (no dropout, or no step seed: evaluation): each targeted module
  runs with ``(W.float() + alpha * up @ down).to(W.dtype)``;
* branch (``dropout > 0`` and a step seed): ``out = base(x) + alpha *
  up(down(dropout(x)))`` in fp32, JAX's flax interceptor done with the
  module's own forward replaced.

Either way the targeted modules compute from the pairs inside their own
``forward`` (the instance attribute shadows the class's), so a block
recomputed under remat in the backward reads the same pairs and draws
the same dropout mask: each module's mask comes from a generator seeded
from the step seed and the crc32 of its JAX path (JAX folds that crc32
into its key).  A test can hand in JAX's masks (``masks=``), as
``seeds=`` hands in JAX's rounding seeds.
"""
from __future__ import annotations

import math
import re
import zlib
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_TARGETS = (r"attn\d/(to_q|to_k|to_v|to_out_0)",)
_BLOCK = re.compile(r"^(down_blocks|up_blocks)_\d+$")


def jax_path(name: str, component: str = "unet",
             module: Optional[nn.Module] = None) -> str:
    """The flax path of a port weight or bias of ``component`` ("unet",
    "vae", "clip_l" or "clip_g"): 'down_blocks.1.attentions.0.
    transformer_blocks.0.attn1.to_q.weight' -> 'params/down_blocks_1_
    attentions_0/transformer_blocks_0/attn1/to_q/kernel'.  ``module``, the
    parameter's owner, names the leaf: a norm's weight is 'scale', an
    embedding's 'embedding', CLIP's position embedding the bare
    'position_embedding'; without it a weight is a Linear's or Conv2d's
    'kernel' (LoRA's targets).  Raises where the key map
    (``models/weights.py``) does not take the path back to ``name``."""
    from sdxl_training_improvements_tpu_torch.models import weights as W
    clip = component.startswith("clip")
    key = name
    if clip:  # transformers' scopes, which the flax tree does not have
        for scope in ("text_model.embeddings.", "text_model.encoder.",
                      "text_model."):
            if key.startswith(scope):
                key = key[len(scope):]
                break
    *parts, leaf = key.split(".")
    segs = []
    for p in parts:
        if p.isdigit() and segs:
            segs[-1] += "_" + p
        else:
            segs.append(p)
    # a block and its first child are one flax module: the UNet's
    # 'down_blocks_1_attentions_0', the VAE decoder's 'mid_block_resnets_0'
    for i, seg in enumerate(segs[:-1]):
        if _BLOCK.match(seg) or seg == "mid_block":
            segs[i:i + 2] = [seg + "_" + segs[i + 1]]
            break
    if "mlp" in segs[:-1]:  # CLIP's 'mlp_fc1'
        i = segs.index("mlp")
        segs[i:i + 2] = ["mlp_" + segs[i + 1]]
    if leaf == "bias":
        segs.append("bias")
    elif isinstance(module, nn.Embedding):
        if not (clip and segs == ["position_embedding"]):
            segs.append("embedding")
    elif module is None or isinstance(module, (nn.Linear, nn.Conv2d)):
        segs.append("kernel")
    else:
        segs.append("scale")
    path = "params/" + "/".join(segs)
    back = W._leaf(tuple(path.split("/")), np.zeros((1,)))[0]
    if (W._clip_key(back) if clip else back) != name:
        raise KeyError(f"{name!r} has no flax path ({path!r} maps back to "
                       "another key)")
    return path


def targeted_modules(unet: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS
                     ) -> Dict[str, nn.Module]:
    """Linear and Conv2d modules whose weight's flax path matches a target
    regex (``re.search``, as JAX), by module name, in parameter order."""
    patterns = [re.compile(t) for t in targets]
    out = {}
    for name, mod in unet.named_modules():
        if not isinstance(mod, (nn.Linear, nn.Conv2d)):
            continue
        path = jax_path(f"{name}.weight")
        if any(p.search(path) for p in patterns):
            out[name] = mod
    return out


def lora_init(unet: nn.Module, generator: torch.Generator, rank: int = 4,
              targets: Sequence[str] = DEFAULT_TARGETS,
              dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The tree for every targeted weight, on the weights' device, down ~
    N(0, 1/rank) and up = 0 (module docstring)."""
    mods = targeted_modules(unet, targets)
    if not mods:
        raise ValueError(f"no kernels matched LoRA targets {list(targets)}")
    tree: Dict[str, torch.Tensor] = {}
    for name, mod in mods.items():
        w = mod.weight
        down_shape = (rank, w.shape[1]) + tuple(w.shape[2:])
        tree[f"{name}.down"] = torch.randn(
            down_shape, generator=generator, device=w.device, dtype=dtype
        ) / math.sqrt(rank)
        tree[f"{name}.up"] = torch.zeros((w.shape[0], rank), dtype=dtype,
                                         device=w.device)
    return tree


def lora_pairs(tree: Mapping[str, torch.Tensor]
               ) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor]]:
    """(module name, down, up) of each pair of a tree."""
    for key, down in tree.items():
        if key.endswith(".down"):
            name = key[:-len(".down")]
            yield name, down, tree[f"{name}.up"]


def merged_weight(w: torch.Tensor, down: torch.Tensor, up: torch.Tensor,
                  alpha: float) -> torch.Tensor:
    """``w + alpha * up @ down`` in fp32, cast back to ``w``'s dtype."""
    d = up.float() @ down.float().reshape(down.shape[0], -1)
    d = d.reshape((up.shape[0],) + tuple(down.shape[1:])) * alpha
    return (w.float() + d).to(w.dtype)


def lora_merge(base_params: Mapping[str, torch.Tensor],
               tree: Mapping[str, torch.Tensor], alpha: float = 1.0
               ) -> Dict[str, torch.Tensor]:
    """``base_params`` (UNet parameter name -> tensor) with each targeted
    weight merged; the others are the same tensors."""
    out = dict(base_params)
    with torch.no_grad():
        for name, down, up in lora_pairs(tree):
            key = f"{name}.weight"
            out[key] = merged_weight(base_params[key], down, up, alpha)
    return out


class LoRAAdapter:
    """Replaces the forward of each targeted module of ``unet`` with the
    LoRA one while installed; ``bind`` sets the pairs (and the base, the
    step seed, the masks) the next forwards read."""

    def __init__(self, unet: nn.Module, names: Sequence[str],
                 alpha: float = 1.0, dropout: float = 0.0):
        self.unet = unet
        self.modules = {n: unet.get_submodule(n) for n in names}
        self.paths = {n: jax_path(f"{n}.weight") for n in names}
        self.alpha = alpha
        self.dropout = dropout
        self.tree: Mapping[str, torch.Tensor] = {}
        self.base: Optional[Mapping[str, torch.Tensor]] = None
        self.seed: Optional[int] = None
        self.masks: Optional[Mapping[str, torch.Tensor]] = None
        self.branch = False
        self.matched: set = set()
        for name, mod in self.modules.items():
            mod.forward = self._forward_of(name, mod)

    def remove(self) -> None:
        """Give each module its class's forward back."""
        for mod in self.modules.values():
            del mod.forward

    def bind(self, tree, base=None, seed=None, masks=None,
             branch: Optional[bool] = None) -> None:
        self.tree, self.base, self.seed, self.masks = tree, base, seed, masks
        self.branch = (self.dropout > 0.0 and (seed is not None
                                               or masks is not None)
                       if branch is None else branch)
        self.matched = set()

    @contextmanager
    def bound(self, tree, **kw):
        """``bind`` for the body, the previous binding restored after."""
        saved = (self.tree, self.base, self.seed, self.masks, self.branch)
        self.bind(tree, **kw)
        try:
            yield
        finally:
            self.tree, self.base, self.seed, self.masks, self.branch = saved

    def _weights(self, name: str, mod: nn.Module):
        if self.base is None:
            return mod.weight, mod.bias
        return (self.base[f"{name}.weight"],
                self.base.get(f"{name}.bias") if mod.bias is not None
                else None)

    def _mask(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.masks is not None:
            return self.masks[name].to(x.device)
        crc = zlib.crc32(self.paths[name].encode())
        gen = torch.Generator(device=x.device).manual_seed(
            (self.seed * 0x9E3779B97F4A7C15 + crc) % 2 ** 63)
        return torch.rand(x.shape, generator=gen, device=x.device) < (
            1.0 - self.dropout)

    def _forward_of(self, name: str, mod: nn.Module) -> Callable:
        conv = isinstance(mod, nn.Conv2d)

        def run(x, w, b):
            if not conv:
                return F.linear(x, w, b)
            return F.conv2d(x, w, b, mod.stride, mod.padding, mod.dilation,
                            mod.groups)

        def forward(x):
            w, b = self._weights(name, mod)
            down, up = self.tree[f"{name}.down"], self.tree[f"{name}.up"]
            if not self.branch:
                return run(x, merged_weight(w, down, up, self.alpha), b)
            self.matched.add(name)
            xd = x.float()
            if self.dropout > 0.0:
                xd = torch.where(self._mask(name, x),
                                 xd / (1.0 - self.dropout), 0.0)
            if conv:
                h = F.conv2d(xd, down.float(), None, mod.stride, mod.padding,
                             mod.dilation, mod.groups)
                delta = torch.einsum("brhw,or->bohw", h, up.float())
            else:
                delta = (xd @ down.float().t()) @ up.float().t()
            out = run(x, w, b)
            return out + (delta * self.alpha).to(out.dtype)

        return forward


def lora_train_wrappers(model, generator: torch.Generator, rank: int = 4,
                        alpha: float = 1.0,
                        targets: Sequence[str] = DEFAULT_TARGETS,
                        dropout: float = 0.0
                        ) -> Tuple[Dict[str, torch.Tensor], Callable]:
    """(tree, apply_fn) for an ``SDXLModel``: ``apply_fn(tree, sample,
    timesteps, ..., base_params=None, seed=None, masks=None, branch=None)``
    runs the UNet with the adapters; ``base_params`` (the frozen UNet
    parameters, the train step's ``const_params``) supplies the targeted
    modules' weights, ``seed`` (an int per step) turns on the dropout
    branch.  The tree's tensors require gradients; ``apply_fn.adapter`` is
    the ``LoRAAdapter`` installed on ``model.unet``."""
    tree = lora_init(model.unet, generator, rank=rank, targets=targets)
    for t in tree.values():
        t.requires_grad_(True)
    adapter = LoRAAdapter(model.unet, [n for n, _, _ in lora_pairs(tree)],
                          alpha=alpha, dropout=dropout)

    def apply_fn(lora_tree, *args, base_params=None, seed=None, masks=None,
                 branch=None, **kwargs):
        adapter.bind(lora_tree, base=base_params, seed=seed, masks=masks,
                     branch=branch)
        out = model.unet_apply(*args, **kwargs)
        if adapter.branch:
            missing = set(adapter.modules) - adapter.matched
            if missing:
                raise ValueError(
                    f"{len(missing)} LoRA pairs never reached their module "
                    f"during apply, e.g. {sorted(missing)[:3]}")
        return out

    apply_fn.adapter = adapter
    return tree, apply_fn


# ------------------------------------------------------------- embeddings
def extend_token_embedding(clip_params: Mapping[str, torch.Tensor],
                           generator: Optional[torch.Generator],
                           num_new_tokens: int,
                           noise: Optional[torch.Tensor] = None):
    """Append ``num_new_tokens`` trainable rows, N(0, 1) * the embedding's
    std, to a CLIP state dict's token embedding; returns (the new state
    dict, the first new token id).  ``noise`` ([n, dim] fp32) replaces the
    draw."""
    key = next(k for k in clip_params if k.endswith(
        "token_embedding.weight"))
    emb = clip_params[key]
    std = emb.float().std(correction=0)
    if noise is None:
        noise = torch.randn(num_new_tokens, emb.shape[1], generator=generator,
                            device=emb.device)
    new = (noise.float() * std).to(emb.dtype)
    out = dict(clip_params)
    out[key] = torch.cat([emb, new], dim=0)
    return out, emb.shape[0]
