"""Diffusers-layout checkpoint export and import, in PyTorch.

Port of ``export_diffusers``/``_write_diffusers`` and ``import_diffusers``
from ``sdxl_training_improvements_tpu/training/checkpoints.py``
(``:148-208``, ``:324-359``), on the port's own safetensors reader and
writer (``models/weights.py``).  The files are the JAX package's:

    unet/diffusion_pytorch_model.safetensors  (+ unet/config.json)
    vae/diffusion_pytorch_model.safetensors
    text_encoder/model.safetensors            (CLIP-L; absent: refiner)
    text_encoder_2/model.safetensors          (CLIP-G, with projection)
    scheduler/scheduler_config.json           (optional)
    config.json                               (the port's Config)

Train-state save/resume and LoRA export are not ported (ROADMAP queue 1,
item 12).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Set

from torch import nn

from sdxl_training_improvements_tpu_torch.models import weights as W

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
                     unet_config=None) -> int:
    """Write diffusers-layout safetensors for every component in
    ``modules`` ({unet, vae, clip_l, clip_g}; ``components(model)`` gives
    an ``SDXLModel``'s), one tensor at a time from wherever it lives.
    ``unet_config`` also writes ``unet/config.json``
    (``UNetConfig.to_diffusers_config``), from which ``from_pretrained``
    rebuilds variant topologies; ``config`` (a root ``Config``) the root
    ``config.json``.  Returns the bytes of tensor files written."""
    ckpt_dir = Path(ckpt_dir)
    written = 0
    if "unet" in modules:
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
