"""Where a training step's time goes: ``torch.profiler`` over the port's
train step, the top kernels by self device time and a rollup by
category.

Port of ``tools/profile_step.py`` (JAX: an xprof trace of the bench's
fwd+bwd and its per-HLO-op table).  Here the step is the port's whole
``make_train_step`` on the default ``Config()`` (ddpm, adamw_bf16 with
hash noise, so the optimizer's kernel #7 is in it): full-width SDXL-base
(``--tiny`` for the miniature), bf16, ``--batch`` latents of
``--hw``^2 (128: 1024^2 images), remat ``--remat`` (``full``, a policy
name of ``models/unet.py``, or ``off``).  After one warm-up step it
profiles ``--steps`` steps between two synchronizes and prints:

* the total device time and the device's idle share of the window;
* the top ``--top`` kernels by self device time (calls, ms, share);
* the rollup by category (``kernel_group``: GEMM, convolution, the
  hand-written flash, GN+SiLU and fused AdamW kernels, norm/softmax,
  elementwise, copy, NCCL).

    python -m sdxl_training_improvements_tpu_torch.tools.profile_step \\
        --batch 4 --remat full [--hw 128] [--steps 2] [--out prof.json]

On the CPU (``--device cpu``, e.g. with ``--tiny``) the same tables hold
the operators' self host time, named so; no device time is claimed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import torch

from sdxl_training_improvements_tpu_torch.tools import card, require_device

# (category, substrings of a kernel's name), first match wins
KERNEL_GROUPS = (
    ("flash_fwd (hand CUDA)", ("flash_fwd", "flash_f32_fwd")),
    ("flash_bwd (hand CUDA)", ("flash_bwd", "dkv_reduce", "flash_f32_dq",
                               "flash_f32_dkv")),
    ("fused_adamw (hand CUDA)", ("fused_adamw",)),
    ("gn_silu (hand CUDA)", ("gn_silu",)),
    ("probe (hand Triton)", ("probe_kernel",)),
    ("nccl", ("nccl",)),
    ("convolution", ("conv", "fprop", "implicit", "nhwc", "dgrad",
                     "wgrad")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
    ("norm/softmax", ("norm", "softmax", "welford", "reduce")),
    ("copy", ("copy", "memcpy", "memset", "cat", "index")),
    ("elementwise", ("elementwise", "vectorized", "upsample")),
)


def kernel_group(name: str) -> str:
    """The category of a device event (a kernel, copy or set) by its
    name; ``"other"`` when none matches."""
    n = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in n for k in keys):
            return group
    return "other"


def device_events(prof) -> list:
    """(name, ms) of every device event (kernel, copy, set) a profile
    recorded, read from the profiler's raw events: ``key_averages()``
    first parses every event into Python objects, tens of seconds for
    a step of ~500,000 launches."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        return [(e.key, e.self_device_time_total / 1e3)
                for e in prof.key_averages() if e.self_device_time_total > 0]
    return [(e.name(), e.duration_ns() / 1e6) for e in raw.events()
            if e.device_type() != torch.autograd.DeviceType.CPU]


def host_events(prof) -> list:
    """(name, ms) of every operator call's self host time (a CPU profile;
    each call of an operator at its average)."""
    return [(e.key, e.self_cpu_time_total / 1e3 / e.count)
            for e in prof.key_averages() if e.self_cpu_time_total > 0
            for _ in range(e.count)]


def summarize(events, wall_ms: float, top: int = 30,
              device: bool = True) -> dict:
    """Totals, the top ``top`` names and the rollup by ``kernel_group``
    of (name, ms) events over a window of ``wall_ms``."""
    by_name: dict = {}
    for name, ms in events:
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + ms)
    busy = sum(ms for _, ms in events)
    groups: dict = {}
    for name, (n, ms) in by_name.items():
        g = groups.setdefault(kernel_group(name), {"ms": 0.0, "calls": 0})
        g["ms"] += ms
        g["calls"] += n
    for g in groups.values():
        g["share"] = g["ms"] / busy if busy else 0.0
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "time": "device" if device else "host (CPU operators' self time)",
        "wall_ms": wall_ms,
        "busy_ms": busy,
        "idle_share": (1 - busy / wall_ms) if device and wall_ms else None,
        "events": len(events),
        "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"])),
        "top": [{"name": name, "calls": n, "ms": ms,
                 "share": ms / busy if busy else 0.0,
                 "group": kernel_group(name)}
                for name, (n, ms) in rows],
    }


def build_step(batch: int, remat: str, hw: int, device, tiny: bool = False):
    """(step, state, batch) of the default ``Config()`` train step."""
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        create_train_state, make_train_step)
    cfg = Config()
    cfg.training.batch_size = batch
    cfg.training.gradient_accumulation_steps = 1
    ucfg = (UNetConfig.tiny if tiny else UNetConfig.sdxl)(
        remat=remat != "off", remat_policy="full" if remat == "off"
        else remat)
    model = SDXLModel.create(
        tiny=tiny, dtype=torch.bfloat16, device=device, unet_config=ucfg,
        generator=torch.Generator(device=device).manual_seed(0))
    opt = make_optimizer(cfg)
    step = make_train_step(model.unet_apply, NoiseSchedule.from_config(cfg),
                           opt, cfg)
    state = create_train_state(model.trainable_params(), opt)
    gen = torch.Generator(device=device).manual_seed(1)
    b = {"vae_latents": torch.randn(batch, 4, hw, hw, generator=gen,
                                    device=device),
         "prompt_embeds": torch.zeros(batch, 77, ucfg.cross_attention_dim,
                                      device=device),
         "pooled_prompt_embeds": torch.zeros(batch, ucfg.pooled_embed_dim,
                                             device=device),
         "time_ids": torch.tensor([[hw * 8.0, hw * 8, 0, 0, hw * 8,
                                    hw * 8]] * batch, device=device)}
    return step, state, b


def profile(batch: int = 4, remat: str = "full", hw: int = 128,
            steps: int = 2, top: int = 30,
            device: str = "cuda", tiny: bool = False) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    dev = require_device(device)
    on_card = dev.type == "cuda"
    step, state, b = build_step(batch, remat, hw, dev, tiny=tiny)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)
    losses = []
    state, m = step(state, b)  # warm-up
    losses.append(m["loss"])
    sync()
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, b)
            losses.append(m["loss"])
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof) if on_card else host_events(prof)
    out = summarize(events, wall_ms, top=top, device=on_card)
    out.update(batch=batch, remat=remat, hw=hw, steps=steps, tiny=tiny,
               device=str(dev), card=card(dev),
               wall_ms_per_step=wall_ms / steps,
               losses=[float(x) for x in losses])
    return out


def print_report(out: dict) -> None:
    what, idle = out["time"], out["idle_share"]
    print(f"[profile_step] b{out['batch']} remat {out['remat']} hw "
          f"{out['hw']}: {out['steps']} steps, wall {out['wall_ms']:.2f} ms, "
          f"{what} busy {out['busy_ms']:.2f} ms, idle share "
          f"{idle if idle is None else round(idle, 3)}, {out['events']} "
          f"events ({out['card'] or out['device']})")
    print(f"== rollup by category ({what} ms) ==")
    for g, v in out["groups"].items():
        print(f"  {g:<26} {v['ms']:10.2f} ms {100 * v['share']:5.1f}%  "
              f"calls {v['calls']}")
    print(f"== top {len(out['top'])} by self {what} time ==")
    for r in out["top"]:
        print(f"  {r['ms']:9.3f} ms {100 * r['share']:5.1f}% n={r['calls']:<5}"
              f" [{r['group']}] {r['name'][:110]}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--remat", default="full",
                    help="remat policy name, or 'off'")
    ap.add_argument("--hw", type=int, default=128,
                    help="latent side (128: 1024^2 images)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    out = profile(args.batch, args.remat, args.hw, args.steps, args.top,
                  args.device, args.tiny)
    print_report(out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
