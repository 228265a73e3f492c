"""Parameters and optimizer state of the JAX package -> the port's.

Reproduces the key mapping of ``sdxl_training_improvements_tpu/models/
weights.py`` (``_flax_seg_to_hf``, ``_leaf_to_hf``, ``_clip_flax_to_hf``)
without importing JAX: the input is the flax parameter tree as nested dicts
of numpy arrays.  The port's modules use the same diffusers/transformers
key names, so ``load_state_dict(..., strict=True)`` takes the result.

* Linear ``kernel`` [in, out] -> ``weight`` [out, in]
* Conv ``kernel`` HWIO -> ``weight`` OIHW
* Norm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``

A gradient tree maps the same way.  ``from_jax_opt_state`` maps the JAX
``AdamWBF16State`` (per-leaf layout) onto the port's optimizer state, so
both optimizers can start from the same state.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# flax segments that are indexed in diffusers: foo_3 -> foo.3
_INDEXED = (
    "down_blocks", "up_blocks", "resnets", "attentions", "downsamplers",
    "upsamplers", "transformer_blocks", "to_out", "net", "layers",
)
_CLIP_PREFIX = "text_model."


def _seg_to_key(seg: str) -> str:
    """'down_blocks_1_attentions_0' -> 'down_blocks.1.attentions.0';
    'mlp_fc1' -> 'mlp.fc1'; plain names pass through."""
    if seg.startswith("mlp_fc"):
        return "mlp." + seg[4:]
    out = (seg.replace("mid_block_resnets", "mid_block.resnets")
              .replace("mid_block_attentions", "mid_block.attentions"))
    for name in _INDEXED:
        out = re.sub(rf"{name}_(\d+)", rf"{name}.\1", out)
    return re.sub(r"(\d)_([A-Za-z])", r"\1.\2", out)


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def _to_torch(arr) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16, as JAX hands it out
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf(path: Tuple[str, ...], value) -> Tuple[str, torch.Tensor]:
    *mods, leaf = [p for p in path if p != "params"]
    keys = [_seg_to_key(m) for m in mods]
    arr = np.asarray(value)
    if leaf == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:  # [in, out] -> [out, in]
            arr = arr.T
    elif leaf not in ("scale", "embedding", "bias"):
        keys.append(_seg_to_key(leaf))  # a bare param (position_embedding)
    name = "bias" if leaf == "bias" else "weight"
    return ".".join(keys + [name]), _to_torch(arr)


def _clip_key(key: str) -> str:
    """CLIP keys get transformers' ``text_model.``/``embeddings.`` scope."""
    if key.startswith("text_projection"):
        return key
    if key.startswith(("token_embedding", "position_embedding")):
        return _CLIP_PREFIX + "embeddings." + key
    if key.startswith("layers."):
        return _CLIP_PREFIX + "encoder." + key
    return _CLIP_PREFIX + key


def from_jax_params(tree, clip: bool = False) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of numpy arrays, with or without
    the top-level ``params``) -> the port's state dict.  ``clip=True`` for
    a CLIP text encoder's tree."""
    out = {}
    for path, value in _leaves(tree):
        key, t = _leaf(path, value)
        out[_clip_key(key) if clip else key] = t
    return out


def from_jax_opt_state(state, like: Optional[Mapping[str, torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None):
    """JAX ``AdamWBF16State`` (per-leaf layout; its trees as numpy arrays)
    -> the port's ``AdamWBF16State``: the moments and shift through the
    parameters' key and layout mapping, ``accumulated_decay`` per key as
    0-d fp32 tensors, and ``step``.  ``like`` (the port's parameters by
    name) gives each state tensor its parameter's device and strides, as
    the port's ``init`` lays it out.  ``generator`` (a CPU generator,
    seeded with 0 when None) draws the port's next per-leaf seeds."""
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        AdamWBF16State)

    def tree(t):
        out = from_jax_params(t)
        if like is None:
            return out
        return {k: torch.empty_like(like[k], dtype=v.dtype).copy_(v)
                for k, v in out.items()}

    acc = {k: v.float().reshape(()) for k, v in
           from_jax_params(state.accumulated_decay).items()}
    return AdamWBF16State(
        step=int(np.asarray(state.step)), exp_avg=tree(state.exp_avg),
        exp_avg_sq=tree(state.exp_avg_sq), shift=tree(state.shift),
        accumulated_decay=acc,
        generator=generator or torch.Generator().manual_seed(0))
