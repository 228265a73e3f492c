"""The repo's tools on the port: each module keeps the name of its
counterpart under ``tools/`` and runs as ``python -m
sdxl_training_improvements_tpu_torch.tools.<name>``.

* ``parity_check``: the port's training step on the tiny UNet against
  JAX's loss curve (``tests/fixtures/parity``), the <= 1% bar;
* ``finetune_demo``: the shapes dataset, the VAE pretrain, the base
  train, the LoRA fine-tune with its concept gate, and the full-scale
  LoRA run;
* ``study_int8_moments``: adamw_bf16 with bf16 moments, with int8
  moments, and plain fp32 AdamW on the same draws;
* ``bench_precompute``: the latent-cache precompute, serial against the
  three-stage pipeline;
* ``verify_checkpoint``: the key and shape audit of a diffusers-layout
  checkpoint;
* ``profile_step``: a train step's device time by kernel and category.

Every entry point runs on the card unless ``--device cpu`` is given
(``verify_checkpoint`` runs no model).  None imports JAX, yaml, PIL or the
JAX package.
"""
from __future__ import annotations

import subprocess
from typing import Optional

import torch


def require_device(device: str) -> torch.device:
    """``device`` as a ``torch.device``; a card that is not there raises
    (a tool never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: torch.cuda.is_available() "
                           "is False; pass --device cpu to run on the CPU")
    return dev


def card(device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them, or None on the
    CPU."""
    if torch.device(device).type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return smi.stdout.strip().splitlines()[0]
