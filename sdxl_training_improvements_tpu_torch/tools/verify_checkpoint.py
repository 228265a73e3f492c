"""Check that a diffusers-layout SDXL checkpoint maps cleanly onto the
port's models before a training run commits to it.

Port of ``tools/verify_checkpoint.py``.  For every component directory
present (``unet/``, ``vae/``, ``text_encoder/``, ``text_encoder_2/``) it
reads the safetensors (``models/weights.py`` ``load_safetensors_dir``)
and runs the key and shape audit (``check_bijective``) against the
module built on the meta device (no weights, no device): a checkpoint
key that no parameter takes, a parameter the checkpoint leaves at init
or a shape that disagrees is reported, and the exit code is 1.  It runs
no model, so it needs no card.

    python -m sdxl_training_improvements_tpu_torch.tools.verify_checkpoint \\
        /path/to/stable-diffusion-xl-base-1.0 [--tiny]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import torch

# transformers' CLIP checkpoints may carry this buffer; no parameter
# takes it (JAX's audit drops it too)
CLIP_BUFFERS = ("text_model.embeddings.position_ids",)


def _modules(tiny: bool) -> dict:
    """Component directory -> (name, a builder of its module)."""
    from sdxl_training_improvements_tpu_torch.models.clip import (
        CLIPTextConfig, CLIPTextModel)
    from sdxl_training_improvements_tpu_torch.models.unet import (
        SDXLUNet, UNetConfig)
    from sdxl_training_improvements_tpu_torch.models.vae import (
        AutoencoderKL, VAEConfig)
    if tiny:
        cfgs = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                CLIPTextConfig.tiny(projection=True))
    else:
        cfgs = (UNetConfig.sdxl(), VAEConfig.sdxl(), CLIPTextConfig.clip_l(),
                CLIPTextConfig.clip_g())
    return {"unet": ("unet", lambda: SDXLUNet(cfgs[0])),
            "vae": ("vae", lambda: AutoencoderKL(cfgs[1])),
            "text_encoder": ("clip_l", lambda: CLIPTextModel(cfgs[2])),
            "text_encoder_2": ("clip_g", lambda: CLIPTextModel(cfgs[3]))}


def verify(model_dir, tiny: bool = False, out=print) -> int:
    """0 when every component present maps bijectively, 1 when one does
    not, 2 when no component directory is there."""
    from sdxl_training_improvements_tpu_torch.models import weights as W
    model_dir = Path(model_dir)
    failures, checked = 0, 0
    for sub, (name, build) in _modules(tiny).items():
        if not (model_dir / sub).exists():
            continue
        checked += 1
        state = W.load_safetensors_dir(model_dir / sub)
        if sub.startswith("text_encoder"):
            for k in CLIP_BUFFERS:
                state.pop(k, None)
        with torch.device("meta"):
            module = build()
        try:
            missing, unused = W.check_bijective(module, state)
        except ValueError as e:  # a shape mismatch
            out(f"[{name}] FAIL: {e}")
            failures += 1
            continue
        if missing or unused:
            failures += 1
            out(f"[{name}] FAIL: {len(missing)} model params unfilled, "
                f"{len(unused)} checkpoint keys ignored")
            for k in missing[:5]:
                out(f"    missing: {k}")
            for k in unused[:5]:
                out(f"    unused:  {k}")
        else:
            out(f"[{name}] OK: {len(state)} tensors map bijectively")
    if not checked:
        out(f"no component directories found under {model_dir}")
        return 2
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model_dir", type=Path)
    p.add_argument("--tiny", action="store_true",
                   help="check against the tiny test topology instead")
    args = p.parse_args(argv)
    return verify(args.model_dir, tiny=args.tiny)


if __name__ == "__main__":
    sys.exit(main())
