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

Diffusers interop (JAX ``models/weights.py:88-278``): a safetensors reader
and writer of the port's own (the card's machine has no ``safetensors``
package), the sharded ``*.safetensors.index.json`` layout, the key audit
``check_bijective`` and ``load_*``/``save_*`` per component.  The port's
module names already are the diffusers/transformers keys, so import is
``load_state_dict(strict=True)``, which casts each tensor to the module's
dtype as it copies.  The reader maps each file (``mmap``) and hands out
tensors that view it (``torch.frombuffer``), one at a time: a 2.567B UNet
never needs two host copies.
"""
from __future__ import annotations

import json
import mmap
import re
import struct
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

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


# ------------------------------------------------------ safetensors files
# the format: an 8-byte little-endian header length, a JSON header (per
# tensor its dtype, shape and data_offsets into the data block, and an
# optional "__metadata__" of strings), then the raw little-endian bytes
_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file -> CPU tensors by key, each a view of a
    copy-on-write mapping of the file (writing to a tensor never touches
    the file): no bytes are read until a tensor is used, and the mapping
    lives as long as its tensors."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise ValueError(f"{path}: corrupt safetensors header ({e})")
        size = path.stat().st_size
        mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
              if size > 8 + n else None)
    header.pop("__metadata__", None)
    base, out = 8 + n, {}
    for key, info in header.items():
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {key} has unsupported dtype "
                             f"{info['dtype']!r}")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = 1
        for d in shape:
            count *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or base + end > size:
            raise ValueError(f"{path}: {key} data_offsets {begin, end} do "
                             f"not fit {info['dtype']} {list(shape)}")
        if count == 0:
            out[key] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:  # unaligned: copy the bytes out
            out[key] = torch.frombuffer(
                bytearray(mm[base + begin:base + end]), dtype=dtype
            ).reshape(shape)
        else:
            out[key] = torch.frombuffer(mm, dtype=dtype, count=count,
                                        offset=base + begin).reshape(shape)
    return out


def save_safetensors(state: Mapping[str, torch.Tensor], path) -> int:
    """Write ``state`` (tensors on any device) to one ``.safetensors``
    file, copying one tensor at a time to the host; returns the bytes
    written.  Tensors are laid out by descending element size, then key,
    so every offset is aligned to its element."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    order = sorted(state, key=lambda k: (-state[k].element_size(), k))
    header: Dict[str, object] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for k in order:
        t = state[k]
        if t.dtype not in _NAMES:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in order:
            t = state[k].detach()
            if t.numel():
                f.write(t.to("cpu", memory_format=torch.contiguous_format)
                        .reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + offset


def load_safetensors_dir(model_dir) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` under a component directory, as one state
    dict (``read_safetensors``), the sharded layout included.  A key in
    two files raises (a precision-variant snapshot beside the main file
    would otherwise load whichever sorts last).  With a sharded
    ``*.safetensors.index.json``, each key its ``weight_map`` names must
    be in the file it names."""
    model_dir = Path(model_dir)
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {model_dir}")
    state: Dict[str, torch.Tensor] = {}
    owner: Dict[str, str] = {}
    for f in files:
        part = read_safetensors(f)
        dup = set(part) & set(state)
        if dup:
            k = sorted(dup)[0]
            raise ValueError(
                f"duplicate tensor keys across safetensors files in "
                f"{model_dir}: e.g. {k!r} in both {owner[k]} and {f.name}. "
                "Keep a single precision variant per component directory.")
        state.update(part)
        owner.update(dict.fromkeys(part, f.name))
    for index in sorted(model_dir.glob("*.safetensors.index.json")):
        weight_map = json.loads(index.read_text()).get("weight_map", {})
        for k, fname in weight_map.items():
            if owner.get(k) != fname:
                raise ValueError(
                    f"{index}: {k!r} is mapped to {fname} but found in "
                    f"{owner.get(k, 'no file')}")
    return state


# ------------------------------------------------------------ components
def _shape(v) -> Tuple[int, ...]:
    return tuple(v.shape) if hasattr(v, "shape") else tuple(v)


def check_bijective(module: torch.nn.Module, state: Mapping
                    ) -> Tuple[List[str], List[str]]:
    """Key audit between a module and a checkpoint state (key -> tensor,
    or a shape as in the key/shape manifests): ``(missing, unused)``, the
    keys the module needs that the state lacks and the state's keys that
    no parameter takes.  Both empty: every checkpoint tensor lands in
    exactly one parameter and back.  A shape that disagrees raises."""
    needed = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    missing = sorted(set(needed) - set(state))
    unused = sorted(set(state) - set(needed))
    for k in sorted(set(needed) & set(state)):
        if _shape(state[k]) != needed[k]:
            raise ValueError(f"shape mismatch for {k}: checkpoint "
                             f"{_shape(state[k])} vs model {needed[k]}")
    return missing, unused


def load_component(module: torch.nn.Module, model_dir) -> None:
    """Fill ``module`` from the safetensors of one component directory,
    strictly: a missing, unused or misshapen key raises before any
    parameter is written; every tensor is cast to its parameter's dtype
    and moved to its device as it is copied."""
    state = load_safetensors_dir(model_dir)
    missing, unused = check_bijective(module, state)
    if missing or unused:
        raise KeyError(f"{model_dir}: {len(missing)} keys missing (e.g. "
                       f"{missing[:3]}), {len(unused)} unused (e.g. "
                       f"{unused[:3]})")
    with torch.no_grad():
        module.load_state_dict(state, strict=True)


def save_component(module: torch.nn.Module, path) -> int:
    """A module's state dict (its names are the diffusers keys; a CLIP's
    are transformers' ``text_model.*`` and ``text_projection.weight``, as
    ``_clip_key`` maps the JAX package's tree) to ``path``; returns the
    bytes written."""
    return save_safetensors(module.state_dict(), path)


load_unet = load_vae = load_clip = load_component
save_unet = save_vae = save_component


def save_clip(module: torch.nn.Module, path,
              with_projection: bool = False) -> int:
    """As ``save_component``; ``with_projection`` must say whether the
    encoder has its ``text_projection`` (CLIP-G does), as JAX's
    ``save_clip`` checks: text_encoder_2 without it is a broken SDXL
    checkpoint."""
    has = hasattr(module, "text_projection")
    if has != with_projection:
        raise ValueError(f"with_projection={with_projection} but the "
                         f"encoder {'has' if has else 'lacks'} a "
                         "text_projection")
    return save_component(module, path)
