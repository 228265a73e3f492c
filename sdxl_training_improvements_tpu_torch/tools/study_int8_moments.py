"""The quality study of 8-bit moments (``optimizer.moments_8bit``).

Port of ``tools/study_int8_moments.py``.  int8 moments store Adam's m
and v as 8-bit log codes and one fp32 scale a leaf (``ops/quantize.py``):
does that bend the loss curve or the iterates over a multi-hundred-step
run of the tiny SDXL UNet through the ddpm loss?  Three arms, the same
draws each step:

* ``bf16``: ``adamw_bf16`` with bf16 moments and hash noise (the default);
* ``int8``: ``adamw_bf16`` with 8-bit log-code moments;
* ``fp32``: plain AdamW over fp32 parameters (the gold arm).

Each arm starts from one fp32 start (``parity_check.seeded_unet_state``
at seed 0), cast to the arm's dtype (the UNet's norm parameters stay
fp32, as the port's model keeps them).  Step i draws its latents, noise
and timesteps from a torch generator seeded with 1000 + i on the run's
device.  The JSON holds each arm's window means, the bf16-vs-int8
smoothed divergence and the parameter distances (JAX's keys).

    python -m sdxl_training_improvements_tpu_torch.tools.study_int8_moments \\
        [--steps 400] [--device cuda] [--out outputs/int8_moments_study.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.tools import card, require_device

ARMS = ("bf16", "int8", "fp32")
LR, BETAS, EPS, WD = 5e-4, (0.9, 0.999), 1e-8, 0.01
BATCH, SIZE = 2, 16
OUT = "outputs/int8_moments_study.json"


class Arm:
    """One arm's UNet, optimizer and state; ``step(i)`` is JAX's jitted
    ``step``: the ddpm loss on step i's draws, its gradients, one update
    (no clip, as in JAX's study)."""

    def __init__(self, arm: str, device, start: Dict[str, np.ndarray]):
        from sdxl_training_improvements_tpu_torch.config import Config
        from sdxl_training_improvements_tpu_torch.models.sdxl import (
            SDXLModel)
        from sdxl_training_improvements_tpu_torch.training.methods import (
            get_method)
        from sdxl_training_improvements_tpu_torch.training.optimizers import (
            AdamW, AdamWBF16)
        from sdxl_training_improvements_tpu_torch.training.schedules import (
            NoiseSchedule)
        if arm not in ARMS:
            raise ValueError(f"arm must be one of {ARMS}, got {arm!r}")
        self.arm, self.device = arm, torch.device(device)
        dtype = torch.float32 if arm == "fp32" else torch.bfloat16
        self.model = SDXLModel.create(tiny=True, dtype=dtype,
                                      device=self.device, init_weights=False)
        with torch.no_grad():
            self.model.unet.load_state_dict(
                {k: torch.from_numpy(v) for k, v in start.items()})
        self.params = self.model.trainable_params()
        if arm == "fp32":
            self.opt = AdamW(LR, betas=BETAS, eps=EPS, weight_decay=WD)
        else:
            self.opt = AdamWBF16(lr=LR, betas=BETAS, eps=EPS,
                                 weight_decay=WD, noise="hash",
                                 moments="int8" if arm == "int8" else "bf16")
        self.opt_state = self.opt.init(self.params)
        self.loss_fn = get_method("ddpm")
        self.schedule = NoiseSchedule.create()
        self.mcfg = Config().model
        u = self.model.unet_config
        self.cond = {
            "prompt_embeds": torch.zeros(BATCH, 77, u.cross_attention_dim,
                                         dtype=dtype, device=self.device),
            "pooled_prompt_embeds": torch.zeros(
                BATCH, u.pooled_embed_dim, dtype=dtype, device=self.device),
            "time_ids": torch.zeros(BATCH, 6, device=self.device)}
        self.latent_shape = (BATCH, u.in_channels, SIZE, SIZE)

    def generator(self, i: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(1000 + i)

    def loss_and_grads(self, batch: dict, gen: Optional[torch.Generator]):
        """The ddpm loss of ``batch`` (its own ``noise``/``timesteps`` when
        it has them, else ``gen``'s draws) and its gradients by name."""
        loss, _ = self.loss_fn(self.model.unet_apply, batch, gen,
                               self.schedule, self.mcfg)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    def update(self, grads: Dict[str, torch.Tensor], **kw) -> None:
        """One update (``kw``: the optimizer's, e.g. adamw_bf16's
        ``seeds``)."""
        deltas, self.opt_state = self.opt.update(grads, self.opt_state,
                                                 self.params, **kw)
        with torch.no_grad():
            for n, p in self.params.items():
                p.add_(deltas[n])

    def step(self, i: int) -> torch.Tensor:
        gen = self.generator(i)
        batch = dict(self.cond, vae_latents=torch.randn(
            self.latent_shape, generator=gen, device=self.device))
        loss, grads = self.loss_and_grads(batch, gen)
        self.update(grads)
        return loss


def run_arm(arm: str, steps: int, device, start) -> tuple:
    """(losses, final parameters on the CPU, seconds) of one arm."""
    a = Arm(arm, device, start)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(a.step(i))
    losses = torch.stack(losses).float().cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"[{arm}] {steps} steps in {dt:.1f}s, final-50 mean loss "
          f"{np.mean(losses[-50:]):.5f}", flush=True)
    return losses, {k: v.detach().cpu() for k, v in a.params.items()}, dt


def windows(c: np.ndarray) -> dict:
    k = max(1, len(c) // 8)
    return {
        "first_window_mean": round(float(np.mean(c[:k])), 6),
        "mid_window_mean": round(float(np.mean(
            c[len(c) // 2:len(c) // 2 + k])), 6),
        "final_window_mean": round(float(np.mean(c[-k:])), 6),
    }


def pdist(a: dict, b: dict) -> float:
    """||a - b|| / ||a|| over every parameter, in fp64."""
    num = den = 0.0
    for k in a:
        x, y = a[k].double(), b[k].double()
        num += float((x - y).square().sum())
        den += float(x.square().sum())
    return (num / max(den, 1e-30)) ** 0.5


def study(steps: int, device: str) -> dict:
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    from sdxl_training_improvements_tpu_torch.tools.parity_check import (
        seeded_unet_state)
    dev = require_device(device)
    start = seeded_unet_state(UNetConfig.tiny(), 0)
    curves, finals, seconds = {}, {}, {}
    for arm in ARMS:
        curves[arm], finals[arm], seconds[arm] = run_arm(arm, steps, dev,
                                                         start)
    w = max(1, steps // 16)
    kern = np.ones(w) / w
    sm = {a: np.convolve(curves[a], kern, mode="valid")
          for a in ("bf16", "int8")}
    rel = np.abs(sm["bf16"] - sm["int8"]) / np.maximum(np.abs(sm["bf16"]),
                                                       1e-12)
    return {
        "steps": steps,
        "device": str(dev), "card": card(dev),
        "arms": {a: windows(curves[a]) for a in curves},
        "arm_seconds": {a: round(s, 2) for a, s in seconds.items()},
        "finite": {a: bool(np.isfinite(curves[a]).all()) for a in curves},
        "bf16_vs_int8_smoothed_rel_divergence_max": round(float(rel.max()),
                                                          6),
        "bf16_vs_int8_smoothed_rel_divergence_final": round(float(rel[-1]),
                                                            6),
        "param_rel_dist_bf16_vs_int8": round(pdist(finals["bf16"],
                                                   finals["int8"]), 6),
        "param_rel_dist_bf16_vs_fp32": round(pdist(finals["bf16"],
                                                   finals["fp32"]), 6),
        "note": ("int8 is acceptable when its divergence from bf16 moments "
                 "is the same order as bf16's own divergence from the fp32 "
                 "gold arm (quantization noise <= bf16 rounding noise)"),
        "losses": {a: [float(x) for x in curves[a]] for a in curves},
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    out = study(args.steps, args.device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "losses"},
                     indent=1))
    return 0 if all(out["finite"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
