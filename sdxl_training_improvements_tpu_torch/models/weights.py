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
optimizer states (``AdamWBF16State`` of every layout with bf16 or int8
moments, ``EMAState``, ``ScheduleFreeKahanState``, ``SOAPState``) onto
the port's,
and ``from_jax_lora`` a LoRA tree onto the port's, so both packages can
start from the same state.

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


# port segments joined onto an indexed block's flax segment:
# down_blocks.1.attentions.0 -> down_blocks_1_attentions_0
_BLOCK_PARTS = ("resnets", "attentions", "downsamplers", "upsamplers")


def flax_path(name: str, ndim: int) -> Tuple[str, ...]:
    """The flax path of the port's parameter ``name`` (of ``ndim``
    dimensions), the inverse of ``_leaf`` for the UNet's keys:
    ``down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight``
    -> ``("down_blocks_1_attentions_0", "transformer_blocks_0", "attn1",
    "to_q", "kernel")``.  A LoRA tree's ``<module>.down`` / ``.up`` ->
    (the flax kernel path joined by "/", "down" / "up"), JAX's LoRA keys.
    Sorting by it gives the flatten order of the JAX tree."""
    *mods, leaf = name.split(".")
    if leaf in ("down", "up"):
        return ("/".join(flax_path(".".join(mods + ["weight"]), 2)), leaf)
    segs: List[str] = []
    for tok in mods:
        last = segs[-1] if segs else ""
        if tok.isdigit() or (tok in _BLOCK_PARTS and (
                last == "mid_block" or last.startswith(("down_blocks_",
                                                        "up_blocks_")))):
            segs[-1] = f"{last}_{tok}"
        else:
            segs.append(tok)
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    return tuple(segs) + (leaf,)


def jax_shape(name: str, shape) -> Tuple[int, ...]:
    """The JAX leaf's shape of the port's parameter: a Linear weight
    [out, in] is a kernel [in, out], a Conv weight OIHW one HWIO."""
    shape = tuple(shape)
    if name.endswith(".weight") and len(shape) == 2:
        return shape[::-1]
    if name.endswith(".weight") and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return shape


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


def _key(path: Tuple[str, ...], lora: bool) -> str:
    """The port's name of a JAX tree leaf: a parameter's key, or for a
    LoRA tree (``{flax kernel path: {"down", "up"}}``) ``<module>.down`` /
    ``<module>.up``."""
    if not lora:
        return _leaf(path, np.zeros((1,)))[0]
    flat, which = path[0], path[1]
    module = _leaf(tuple(flat.split("/")), np.zeros((1,)))[0]
    return module[:-len(".weight")] + "." + which


def _lora_layout(which: str, arr: np.ndarray) -> np.ndarray:
    """JAX LoRA factors -> the port's: down [in, r] / [kh, kw, in, r] ->
    [r, in] / [r, in, kh, kw]; up [r, out] -> [out, r]."""
    if which == "down" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr.T


def from_jax_lora(tree) -> Dict[str, torch.Tensor]:
    """JAX LoRA tree (``models/lora.py`` ``lora_init``: flax kernel path ->
    {"down", "up"}, numpy arrays) -> the port's tree (``<module>.down`` /
    ``<module>.up`` in torch's layout, ``models/lora.py``)."""
    return {_key(path, True): _to_torch(_lora_layout(path[-1],
                                                     np.asarray(v)))
            for path, v in _leaves(tree)}


def _is_codes(v) -> bool:
    return isinstance(v, Mapping) and set(v) == {"q", "s"}


def _state_leaves(tree, path=()):
    """``_leaves``, with an int8 moment's ``{"q", "s"}`` as one leaf."""
    for k, v in tree.items():
        if isinstance(v, Mapping) and not _is_codes(v):
            yield from _state_leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def _flat_layout_trees(state, like, optimizer, lora: bool):
    """The bf16 AdamW's flat, hybrid or stacked trees (keys ``flat_{g}``,
    ``stack_{j}``, ``leaf_{i}``) -> the port's: ``leaf_{i}`` is the i-th
    parameter in the JAX flatten order, keyed by its name; a group is cut
    into its parameters (``optimizer.groups(like)``), each mapped to the
    port's layout, laid out like its parameter and concatenated (a stack:
    stacked) in memory order."""
    from sdxl_training_improvements_tpu_torch.training.optimizers.adamw_bf16 \
        import flax_order
    from sdxl_training_improvements_tpu_torch.ops.fused_adamw import (
        memory_order)
    names = flax_order(like)
    groups = optimizer.groups(like)

    def port_leaf(name, arr):
        path = flax_path(name, like[name].dim())
        if lora:
            t = _to_torch(_lora_layout(path[-1], np.asarray(arr)))
        else:
            t = _leaf(path, arr)[1]
        return torch.empty_like(like[name], dtype=t.dtype).copy_(
            t.reshape(like[name].shape))

    def tree(t):
        out = {}
        for k, v in t.items():
            if k.startswith("leaf_"):
                name = names[int(k[len("leaf_"):])]
                out[name] = port_leaf(name, v)
                continue
            members, arr = groups[k], np.asarray(v)
            pieces, off = [], 0
            for j, name in enumerate(members):
                shape = jax_shape(name, like[name].shape)
                if k.startswith("stack_"):
                    piece = arr[j]
                else:
                    size = int(np.prod(shape))
                    piece, off = arr[off:off + size].reshape(shape), \
                        off + size
                pieces.append(memory_order(port_leaf(name, piece)))
            out[k] = (torch.stack if k.startswith("stack_")
                      else torch.cat)(pieces)
        return out

    acc = {}
    for k, v in state.accumulated_decay.items():
        key = names[int(k[len("leaf_"):])] if k.startswith("leaf_") else k
        t = _to_torch(np.asarray(v)).float()
        acc[key] = t if k.startswith("stack_") else t.reshape(())
    return (tree(state.exp_avg), tree(state.exp_avg_sq), tree(state.shift),
            acc)


def from_jax_opt_state(state, like: Optional[Mapping[str, torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None,
                       lora: bool = False, optimizer=None):
    """A JAX optimizer state (its trees as numpy arrays) -> the port's:
    ``AdamWBF16State`` (every layout, bf16 or int8 moments), ``EMAState``
    (recursively), ``ScheduleFreeKahanState`` and ``SOAPState``.  Trees
    shaped like the parameters go through the parameters' key and layout
    mapping (``lora=True``: the LoRA tree's, ``from_jax_lora``); int8
    codes are laid out like their parameter, scales are 0-d; SOAP's
    trees, already in the JAX layout the port's SOAP works in, are only
    re-keyed.  ``like`` (the port's parameters by name) gives each tensor
    shaped like a parameter that parameter's device and strides, as the
    port's ``init`` lays it out.  ``generator`` (a CPU generator, seeded
    with 0 when None) draws the port's next per-leaf seeds.  The flat,
    hybrid and stacked layouts (``flat_{g}``, ``stack_{j}``, ``leaf_{i}``
    keys) need ``like`` and the port's ``optimizer`` (an ``AdamWBF16`` of
    that layout: its partition, and its noise generator under rbg); the
    per-leaf state takes its layout from ``optimizer`` too when given."""
    from sdxl_training_improvements_tpu_torch.training import optimizers as O
    kind = type(state).__name__

    def placed(k, t):
        if like is None:
            return t
        return torch.empty_like(like[k], dtype=t.dtype).copy_(t)

    def leaf(path, v):
        if lora:
            return _to_torch(_lora_layout(path[-1], np.asarray(v)))
        return _leaf(path, v)[1]

    def tree(t):
        out = {}
        for path, v in _state_leaves(t):
            k = _key(path, lora)
            if _is_codes(v):
                q = leaf(path, v["q"])
                out[k] = {"q": placed(k, q),
                          "s": _to_torch(np.asarray(v["s"])).reshape(())}
            else:
                out[k] = placed(k, leaf(path, v))
        return out

    def rekeyed(t):  # SOAP: no layout change
        out = {}
        for path, v in _leaves(t):
            if isinstance(v, (tuple, list)):
                out[_key(path, lora)] = tuple(_to_torch(np.asarray(m))
                                              for m in v)
            else:
                out[_key(path, lora)] = _to_torch(np.asarray(v))
        return out

    step = None if not hasattr(state, "step") else int(np.asarray(
        state.step))
    if kind == "EMAState":
        return O.EMAState(
            inner=from_jax_opt_state(state.inner, like, generator, lora,
                                     getattr(optimizer, "inner", optimizer)),
            ema={k: v.float() for k, v in tree(state.ema).items()},
            count=int(np.asarray(state.count)))
    if kind == "ScheduleFreeKahanState":
        return O.ScheduleFreeKahanState(
            step=step, exp_avg_sq=tree(state.exp_avg_sq), z=tree(state.z),
            kahan_comp=tree(state.kahan_comp))
    if kind == "SOAPState":
        return O.SOAPState(step=step, exp_avg=rekeyed(state.exp_avg),
                           exp_avg_sq=rekeyed(state.exp_avg_sq),
                           gg=rekeyed(state.gg), q=rekeyed(state.q))
    if kind != "AdamWBF16State":
        raise TypeError(f"no port counterpart for JAX state {kind}")
    noise_gen = None
    if optimizer is not None and optimizer.noise == "rbg":
        device = next(iter(like.values())).device if like else "cpu"
        noise_gen = torch.Generator(device=device).manual_seed(0)
    layout = optimizer.layout if optimizer is not None else "per_leaf"
    if any(str(k).startswith(("flat_", "stack_", "leaf_"))
           for k in state.exp_avg):
        if like is None or optimizer is None:
            raise ValueError("a flat, hybrid or stacked JAX state needs "
                             "like= and optimizer=")
        m, v, shift, acc = _flat_layout_trees(state, like, optimizer, lora)
    else:
        m, v, shift = (tree(state.exp_avg), tree(state.exp_avg_sq),
                       tree(state.shift))
        acc = {_key(path, lora): _to_torch(np.asarray(v)).float().reshape(())
               for path, v in _leaves(state.accumulated_decay)}
    return O.AdamWBF16State(
        step=step, exp_avg=m, exp_avg_sq=v, shift=shift,
        accumulated_decay=acc,
        generator=generator or torch.Generator().manual_seed(0),
        layout=layout, noise_generator=noise_gen)


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
