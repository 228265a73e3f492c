"""Checkpoints: the train state for resume, and the diffusers-layout export.

Port of ``sdxl_training_improvements_tpu/training/checkpoints.py``, on the
port's own safetensors reader and writer (``models/weights.py``).  A
checkpoint directory holds::

    state/train_state.safetensors   every parameter and optimizer-state
                                    tensor, under stable names
    state/train_state.json          step, the optimizer's scalars and the
                                    CPU generators' states
    unet/diffusion_pytorch_model.safetensors  (+ unet/config.json)
    vae/diffusion_pytorch_model.safetensors
    text_encoder/model.safetensors            (CLIP-L; absent: refiner)
    text_encoder_2/model.safetensors          (CLIP-G, with projection)
    scheduler/scheduler_config.json           (optional)
    config.json                               (the port's Config)

``state/`` is written as ``state.tmp/`` and renamed when complete (the JAX
package's Orbax tmp-dir commit), so ``latest_checkpoint`` never sees a
torn save.  ``save_train_state(blocking=False)`` (``tpu.
async_checkpointing``) snapshots the state to host memory and writes it on
a worker thread; ``wait_for_saves`` joins it and re-raises its errors.
The generators are part of the state: the train state's draws every
sample's noise and timestep, the bf16 AdamW's every leaf's rounding
seeds, so a resume that dropped them would be a different run.

Over several ranks (``parallel/zero.py``) a save gathers the sharded
optimizer state, the megatron-split parameters (and their state) and
the parameters stored as fsdp chunks, and
rank 0 writes it in the one-card format; a restore reads the one-card
state on every rank, which ``shard_train_state`` then cuts, so a state
saved by ranks of any mesh resumes on any other mesh, or in one process
(Orbax's resharding restore in JAX).

LoRA (JAX ``:210-323``): ``export_lora`` writes the adapter as
``pytorch_lora_weights.safetensors`` in the peft layout with a
``lora_config.json`` sidecar, ``import_lora`` reads it back into the
port's tree (``models/lora.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Set, Tuple

import torch
from torch import nn

from sdxl_training_improvements_tpu_torch.models import weights as W
from sdxl_training_improvements_tpu_torch.parallel import mesh as M

UNET_FILE = Path("unet") / "diffusion_pytorch_model.safetensors"
VAE_FILE = Path("vae") / "diffusion_pytorch_model.safetensors"
CLIP_L_FILE = Path("text_encoder") / "model.safetensors"
CLIP_G_FILE = Path("text_encoder_2") / "model.safetensors"
# component -> its directory in the checkpoint
DIRS = {"unet": "unet", "vae": "vae", "clip_l": "text_encoder",
        "clip_g": "text_encoder_2"}


def components(model) -> Dict[str, nn.Module]:
    """An ``SDXLModel``'s modules by component name (no ``clip_l`` for the
    refiner)."""
    parts = {"unet": model.unet, "vae": model.vae, "clip_l": model.clip_l,
             "clip_g": model.clip_g}
    return {k: v for k, v in parts.items() if v is not None}


def export_diffusers(ckpt_dir, modules: Mapping[str, nn.Module],
                     config=None, scheduler_config: Optional[dict] = None,
                     unet_config=None,
                     unet_state: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> int:
    """Write diffusers-layout safetensors for every component in
    ``modules`` ({unet, vae, clip_l, clip_g}; ``components(model)`` gives
    an ``SDXLModel``'s), one tensor at a time from wherever it lives.
    ``unet_config`` also writes ``unet/config.json``
    (``UNetConfig.to_diffusers_config``), from which ``from_pretrained``
    rebuilds variant topologies; ``config`` (a root ``Config``) the root
    ``config.json``.  ``unet_state`` (the UNet's state dict with other
    weights: EMA's, schedule-free's x, a merged LoRA) is written in place
    of ``modules["unet"]``'s own.  Returns the bytes of tensor files
    written."""
    ckpt_dir = Path(ckpt_dir)
    written = 0
    if "unet" in modules:
        if unet_state is not None:
            written += W.save_safetensors(unet_state, ckpt_dir / UNET_FILE)
        else:
            written += W.save_unet(modules["unet"], ckpt_dir / UNET_FILE)
        if unet_config is not None:
            (ckpt_dir / "unet" / "config.json").write_text(
                json.dumps(unet_config.to_diffusers_config(), indent=2))
    if "vae" in modules:
        written += W.save_vae(modules["vae"], ckpt_dir / VAE_FILE)
    if "clip_l" in modules:
        written += W.save_clip(modules["clip_l"], ckpt_dir / CLIP_L_FILE)
    if "clip_g" in modules:
        written += W.save_clip(modules["clip_g"], ckpt_dir / CLIP_G_FILE,
                               with_projection=True)
    if scheduler_config is not None:
        sdir = ckpt_dir / "scheduler"
        sdir.mkdir(parents=True, exist_ok=True)
        (sdir / "scheduler_config.json").write_text(
            json.dumps(scheduler_config, indent=2))
    if config is not None:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        (ckpt_dir / "config.json").write_text(
            json.dumps(config.to_dict(), indent=2, default=str))
    return written


LORA_FILE = "pytorch_lora_weights.safetensors"


def export_lora(ckpt_dir, lora_tree: Mapping[str, torch.Tensor], rank: int,
                alpha: float, prefix: str = "unet") -> Path:
    """The adapter as ``pytorch_lora_weights.safetensors`` in the
    diffusers/peft layout, ``<prefix>.<module>.lora_A.weight`` [r, in]
    (a convolution's [r, in, kh, kw]) and ``lora_B.weight`` [out, r] (a
    convolution's [out, r, 1, 1]), fp32, plus ``lora_config.json``.  As in
    JAX, alpha is folded into ``lora_B`` and the sidecar declares
    ``lora_alpha == r`` (peft's scaling 1), so every consumer reproduces
    the trained delta."""
    from sdxl_training_improvements_tpu_torch.models.lora import lora_pairs
    ckpt_dir = Path(ckpt_dir)
    state = {}
    for name, down, up in lora_pairs(lora_tree):
        b = up.detach().float() * alpha
        if down.dim() == 4:
            b = b[:, :, None, None]
        state[f"{prefix}.{name}.lora_A.weight"] = down.detach().float()
        state[f"{prefix}.{name}.lora_B.weight"] = b
    out = ckpt_dir / LORA_FILE
    W.save_safetensors(state, out)
    (ckpt_dir / "lora_config.json").write_text(json.dumps(
        {"r": rank, "lora_alpha": rank, "base": prefix,
         "note": "alpha folded into lora_B; apply with scaling 1.0"},
        indent=2))
    return out


def import_lora(path, unet: nn.Module, prefix: str = "unet"
                ) -> Dict[str, torch.Tensor]:
    """Inverse of ``export_lora`` (and a peft file's unet adapters) -> the
    port's tree on the CPU, alpha already folded in: apply it with alpha
    1.  Keys of another prefix (a text encoder's adapters) are skipped
    with a warning; a key that names no Linear or Conv2d of ``unet``, a
    lora_B wider than 1x1, or a module with one half of its pair raise."""
    import logging
    state = W.read_safetensors(path)
    modules = {n for n, m in unet.named_modules()
               if isinstance(m, (nn.Linear, nn.Conv2d))}
    tree: Dict[str, torch.Tensor] = {}
    skipped = []
    for k, v in state.items():
        if not k.endswith((".lora_A.weight", ".lora_B.weight")):
            continue
        mods, which = k.rsplit(".lora_", 1)
        if not mods.startswith(prefix + "."):
            skipped.append(k)
            continue
        name = mods[len(prefix) + 1:]
        if name not in modules:
            raise KeyError(f"LoRA key {k!r} matches no kernel in the model")
        if which.startswith("A"):
            tree[f"{name}.down"] = v.clone()
        else:
            if v.dim() == 4 and tuple(v.shape[2:]) != (1, 1):
                raise ValueError(
                    f"LoRA key {k!r} has a {v.shape[2]}x{v.shape[3]} "
                    "lora_B kernel; only 1x1 up-projections are supported "
                    "(spatial taps belong in lora_A)")
            tree[f"{name}.up"] = (v[:, :, 0, 0] if v.dim() == 4 else v
                                  ).clone()
    if skipped:
        logging.getLogger(__name__).warning(
            "import_lora: skipped %d non-%r adapter keys (e.g. %s)",
            len(skipped), prefix, skipped[0])
    names = {k.rsplit(".", 1)[0] for k in tree}
    incomplete = sorted(n for n in names if f"{n}.down" not in tree
                        or f"{n}.up" not in tree)
    if incomplete:
        raise ValueError(
            f"LoRA file {path} is missing lora_A or lora_B for "
            f"{len(incomplete)} module(s): {incomplete[:5]}")
    return tree


def import_diffusers(model, model_dir) -> Set[str]:
    """Load each component present on disk into ``model`` (an
    ``SDXLModel``) strictly, casting to each module's dtype; returns the
    names loaded.  ``text_encoder/`` is skipped when the model has no
    CLIP-L."""
    model_dir = Path(model_dir)
    loaded = set()
    for name, sub in DIRS.items():
        module = getattr(model, name)
        if module is None or not (model_dir / sub).exists():
            continue
        W.load_component(module, model_dir / sub)
        loaded.add(name)
    return loaded


# ------------------------------------------------------------ train state
STATE_TENSORS = "train_state.safetensors"
STATE_META = "train_state.json"
_POOL: Optional[ThreadPoolExecutor] = None
_PENDING: List[Future] = []
_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix="ckpt-state")
    return _POOL


def wait_for_saves() -> None:
    """Block until every in-flight state save is on disk; re-raise the
    first failure.  Safe with nothing pending."""
    global _PENDING
    with _LOCK:
        pending, _PENDING = _PENDING, []
    for fut in pending:
        fut.result()


def _generator_state(gen: torch.Generator) -> str:
    return bytes(gen.get_state().tolist()).hex()


def _set_generator_state(gen: torch.Generator, text: str) -> None:
    gen.set_state(torch.tensor(list(bytes.fromhex(text)), dtype=torch.uint8))


def _flatten_opt(opt, prefix: str, tensors: Dict[str, torch.Tensor]
                 ) -> dict:
    """Add ``opt``'s tensors to ``tensors`` under ``prefix`` and return its
    JSON-able fields.  A dict field holds per-parameter entries: a tensor
    (``<prefix>.<field>.<name>``), an int8 moment's codes and scale
    (``...<name>.q`` / ``.s``) or a tuple of matrices (``...<name>.<i>``,
    SOAP's, (0, 0) placeholders included); a dataclass field (EMA's inner
    state) nests; generators (a missing one as null), ints and strings
    (the bf16 AdamW's layout) go to the JSON."""
    fields = {}
    for f in dataclasses.fields(opt):
        value = getattr(opt, f.name)
        key = f"{prefix}.{f.name}"
        if isinstance(value, dict):
            for n, t in value.items():
                if isinstance(t, torch.Tensor):
                    tensors[f"{key}.{n}"] = t
                elif isinstance(t, dict):
                    tensors.update({f"{key}.{n}.{k}": v
                                    for k, v in t.items()})
                elif isinstance(t, tuple):
                    tensors.update({f"{key}.{n}.{i}": v
                                    for i, v in enumerate(t)})
                else:
                    raise TypeError(f"optimizer state {key}.{n} of type "
                                    f"{type(t).__name__} cannot be saved")
        elif dataclasses.is_dataclass(value):
            fields[f.name] = {"optimizer": type(value).__name__,
                              "fields": _flatten_opt(value, key, tensors)}
        elif isinstance(value, torch.Generator):
            fields[f.name] = {"generator": _generator_state(value)}
        elif isinstance(value, (int, str)) or value is None:
            fields[f.name] = value
        else:
            raise TypeError(f"optimizer state field {f.name!r} of type "
                            f"{type(value).__name__} cannot be saved")
    return fields


def flatten_train_state(state) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(tensors by stable name, JSON-able scalars) of a ``TrainState``:
    ``params.<name>``, ``opt.<field>.<name>`` for each per-parameter
    entry of the optimizer state (``_flatten_opt``: moments, shift, decay
    phases, EMA's shadow and inner state, schedule-free's z and
    compensation, SOAP's matrices, int8 codes and scales), and the step,
    the optimizer's integer fields and every CPU generator's state."""
    tensors = {f"params.{n}": p for n, p in state.params.items()}
    opt = state.opt_state
    meta = {"step": int(state.step), "generator":
            _generator_state(state.generator),
            "optimizer": type(opt).__name__,
            "optimizer_fields": _flatten_opt(opt, "opt", tensors)}
    return tensors, meta


def _layouts(opt, fields: dict, where: str = "opt"):
    """The first (saved, run's) pair of differing ``layout`` fields, with
    where they are, or None."""
    for name, value in fields.items():
        if isinstance(value, dict) and "fields" in value:
            inner = _layouts(getattr(opt, name, None), value["fields"],
                             f"{where}.{name}")
            if inner:
                return inner
        elif name == "layout" and value != getattr(opt, name, None):
            return value, getattr(opt, name, None), f"{where}.{name}"
    return None


def _restore_fields(opt, fields: dict) -> None:
    for name, value in fields.items():
        if isinstance(value, dict) and "fields" in value:
            inner = getattr(opt, name)
            if value["optimizer"] != type(inner).__name__:
                raise ValueError(f"checkpoint optimizer field {name!r} is "
                                 f"{value['optimizer']}, the run's "
                                 f"{type(inner).__name__}")
            _restore_fields(inner, value["fields"])
        elif isinstance(value, dict):
            _set_generator_state(getattr(opt, name), value["generator"])
        elif value is None or getattr(opt, name) is None:
            if (value is None) != (getattr(opt, name) is None):
                raise ValueError(f"checkpoint optimizer field {name!r} is "
                                 f"{value!r}, the run's "
                                 f"{getattr(opt, name)!r}")
        else:
            setattr(opt, name, value)


def _write_state(ckpt_dir: Path, tensors: Mapping[str, torch.Tensor],
                 meta: dict) -> None:
    tmp, final, old = (ckpt_dir / "state.tmp", ckpt_dir / "state",
                       ckpt_dir / "state.old")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    W.save_safetensors(tensors, tmp / STATE_TENSORS)
    (tmp / STATE_META).write_text(json.dumps(meta, indent=1))
    if final.exists():
        shutil.rmtree(old, ignore_errors=True)
        os.replace(final, old)
    os.replace(tmp, final)
    shutil.rmtree(old, ignore_errors=True)


def _settle_host_copies() -> None:
    """Wait for the card's asynchronous copies into host memory (the
    host-streamed optimizer state's, ``core/offload.py``) before the host
    reads or writes those tensors."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def save_train_state(ckpt_dir, state, config=None,
                     blocking: bool = True) -> int:
    """Save ``state`` (a ``TrainState``) under ``ckpt_dir/state``; returns
    the bytes of its tensors.

    ``blocking=False``: the tensors are first copied to host memory (the
    full train state: parameters and optimizer state), and the files are
    written on a worker thread; the caller may update the state as soon
    as this returns.  At most one save is in flight.  Call
    ``wait_for_saves`` before reading the checkpoint back or exiting.

    A state placed on a mesh (``state.zero``): every rank calls this (the
    sharded tensors are gathered over fsdp and the split ones over the
    tensor axis, onto the host of rank 0), and rank 0 alone writes the
    one-card format."""
    ckpt_dir = Path(ckpt_dir).absolute()
    main = M.is_main_process()
    if main:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    _settle_host_copies()
    tensors, meta = flatten_train_state(state)
    zero = getattr(state, "zero", None)
    if zero is not None:
        mine = sum(t.numel() * t.element_size() for t in tensors.values())
        for key, n, how, _, _ in zero.state_fields(state.opt_state):
            full = zero.gather(n, tensors[key], how)
            if main:
                tensors[key] = full.cpu()
            del full
        # the parameters that every rank holds a piece of: its megatron
        # slice, its stored chunk or the chunk of its slice
        for n in zero.param_pieces():
            full = zero.whole_params({n: state.params[n]})[n]
            if main:
                tensors[f"params.{n}"] = full.cpu()
            del full
        if not main:  # the bytes this rank holds
            return mine
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    if config is not None:
        (ckpt_dir / "config.json").write_text(
            json.dumps(config.to_dict(), indent=2, default=str))
    wait_for_saves()
    if blocking:
        _write_state(ckpt_dir, tensors, meta)
        return nbytes
    snapshot = {k: t.detach().to("cpu", memory_format=torch.contiguous_format,
                                 copy=True)
                for k, t in tensors.items()}
    fut = _pool().submit(_write_state, ckpt_dir, snapshot, meta)
    with _LOCK:
        _PENDING.append(fut)
    return nbytes


def restore_train_state(ckpt_dir, template_state):
    """Load ``ckpt_dir/state`` into ``template_state`` in place (its
    tensors keep their device, dtype and layout) and return it.  Every
    tensor of the template must be in the file with its shape and dtype,
    and nothing else.  The template is a one-card state (over several
    ranks: every rank's, before ``shard_train_state``)."""
    if getattr(template_state, "zero", None) is not None:
        raise ValueError("restore into the one-card train state, then "
                         "place it with shard_train_state")
    wait_for_saves()  # a just-issued save of this directory commits first
    _settle_host_copies()
    sdir = Path(ckpt_dir).absolute() / "state"
    meta = json.loads((sdir / STATE_META).read_text())
    tensors, _ = flatten_train_state(template_state)
    layouts = _layouts(template_state.opt_state,
                       meta.get("optimizer_fields", {}))
    if layouts:
        raise ValueError(
            f"{sdir} holds optimizer state of layout {layouts[0]!r} "
            f"({layouts[2]}); this run's is {layouts[1]!r} "
            "(tpu.flat_optimizer): a state does not resume under another "
            "layout")
    saved = W.read_safetensors(sdir / STATE_TENSORS)
    if set(saved) != set(tensors) or meta["optimizer"] != type(
            template_state.opt_state).__name__:
        missing = sorted(set(tensors) - set(saved))[:3]
        extra = sorted(set(saved) - set(tensors))[:3]
        raise ValueError(
            f"{sdir} does not match this run's train state (optimizer "
            f"{meta['optimizer']} vs {type(template_state.opt_state).__name__}"
            f"; missing e.g. {missing}, unexpected e.g. {extra})")
    with torch.no_grad():
        for k, t in tensors.items():
            src = saved[k]
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(f"{sdir}: {k} is {src.dtype} "
                                 f"{list(src.shape)}, the run's "
                                 f"{t.dtype} {list(t.shape)}")
            t.copy_(src)
    del saved
    template_state.step = meta["step"]
    _set_generator_state(template_state.generator, meta["generator"])
    _restore_fields(template_state.opt_state, meta["optimizer_fields"])
    return template_state


def latest_checkpoint(output_dir) -> Optional[Path]:
    """Most recently written checkpoint under ``output_dir`` (``--resume``
    with no directory), by the mtime of its ``state/``: a fixed name-based
    preference could roll a resumed run back to a stale state."""
    output_dir = Path(output_dir)
    if not output_dir.exists():
        return None
    candidates = list(output_dir.glob("checkpoint-*"))
    for name in ("final_checkpoint", "best_checkpoint"):
        if (output_dir / name).exists():
            candidates.append(output_dir / name)
    with_state = [c for c in candidates if (c / "state").exists()]
    if not with_state:
        return None
    return max(with_state, key=lambda c: (c / "state").stat().st_mtime)
