"""Time the PyTorch port's GroupNorm+SiLU, forward and backward, at every
GroupNorm+SiLU site of the full-width SDXL-base UNet, on one CUDA card.

    python tools/bench_gn.py [label [out.json]]

Imports ``sdxl_training_improvements_tpu_torch`` from ``sys.path``, so the
same script times another checkout of the port when ``PYTHONPATH`` names
it (to compare two versions in one call: parent, change, change, parent).
It goes through the port's public ``groupnorm_silu`` and its autograd
``Function``, whatever that checkout puts behind them.

For each distinct (S, C) site shape it prints one JSON line with the
device time per call from ``torch.profiler`` (the kernels' own time, warm
L2: back-to-back calls on one input) and the kernel launches per call of:

* the forward at batch 4 (the default training step, b4 at 1024^2) and at
  batch 2 (one CFG serving step);
* the backward at batch 4: ``torch.autograd.grad`` of one forward output
  with respect to x, scale and bias, the forward's graph kept;
* as a yardstick the port never calls, ATen's ``F.group_norm`` followed by
  ``F.silu`` (two library calls) on the same values laid out [B, C, S],
  forward and backward.

Then the totals per bf16 training step and per serving forward, weighting
each site by its count in the UNet: under remat "full" a resnet's
forward runs twice a step (forward and recompute) and ``conv_norm_out``'s
once; the backward runs once at every site.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

# (S, C, resnet sites, conv_norm_out sites): the 35 GroupNorm+SiLU sites
# of ``UNetConfig.sdxl()`` at 1024^2 (latents 128^2, 64^2, 32^2): norm1
# and norm2 of each resnet (down 2 + 2 + 2, mid 2, up 3 + 3 + 3) and
# conv_norm_out
SITES = ((16384, 320, 7, 1), (16384, 640, 2, 0), (16384, 960, 1, 0),
         (4096, 320, 1, 0), (4096, 640, 6, 0), (4096, 960, 1, 0),
         (4096, 1280, 1, 0), (4096, 1920, 1, 0),
         (1024, 640, 1, 0), (1024, 1280, 10, 0), (1024, 1920, 1, 0),
         (1024, 2560, 2, 0))
TRAIN_B, SERVE_B, GROUPS, EPS = 4, 2, 32, 1e-5
DEVICE = "cuda"


def device_time(fn, iters: int = 10, tries: int = 3):
    """(device ms per call, kernel launches per call) of ``fn`` from
    ``torch.profiler``, after one warm-up call.  A window in which the
    profiler records fewer launches than the calls made (it drops a
    window now and then) is profiled again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.self_device_time_total > 0]
        launches = sum(e.count for e in events)
        if launches >= iters:
            break
    total_us = sum(e.self_device_time_total for e in events)
    return total_us / iters / 1e3, launches / iters


def _inputs(b, s, c, dtype, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    x = (randn(b, s, c) * 1.5 + 1.0).to(dtype)
    return x, 1.0 + 0.1 * randn(c), 0.1 * randn(c), randn(b, s, c).to(dtype)


def _forward(b, s, c, dtype, seed):
    from sdxl_training_improvements_tpu_torch.ops.groupnorm import (
        groupnorm_silu)
    x, scale, bias, _ = _inputs(b, s, c, dtype, seed)
    with torch.no_grad():
        return device_time(lambda: groupnorm_silu(x, scale, bias, GROUPS,
                                                  EPS))


def _backward(b, s, c, dtype, seed):
    from sdxl_training_improvements_tpu_torch.ops.groupnorm import (
        groupnorm_silu)
    x, scale, bias, dy = _inputs(b, s, c, dtype, seed)
    leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
    y = groupnorm_silu(*leaves, GROUPS, EPS)
    return device_time(functools.partial(torch.autograd.grad, y, leaves, dy,
                                         retain_graph=True))


def _library(b, s, c, dtype, seed):
    """(forward, backward) of F.group_norm then F.silu on [B, C, S]."""
    x, scale, bias, dy = (t.transpose(1, 2).contiguous() if t.dim() == 3
                          else t.to(dtype) for t in _inputs(b, s, c, dtype,
                                                            seed))

    def call(*a):
        return F.silu(F.group_norm(a[0], GROUPS, a[1], a[2], EPS))

    with torch.no_grad():
        fwd = device_time(lambda: call(x, scale, bias))
    leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
    y = call(*leaves)
    bwd = device_time(functools.partial(torch.autograd.grad, y, leaves, dy,
                                        retain_graph=True))
    return fwd, bwd


def main(label: str, out_path=None, dtype=torch.bfloat16) -> None:
    from sdxl_training_improvements_tpu_torch.ops import groupnorm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{label}: {groupnorm.__file__} on {smi}", flush=True)
    rows = []
    totals = dict(train_fwd=0.0, train_bwd=0.0, serve_fwd=0.0,
                  library_train_fwd=0.0, library_train_bwd=0.0,
                  train_fwd_launches=0.0, train_bwd_launches=0.0)
    for seed, (s, c, resnets, outs) in enumerate(SITES):
        fwd, fwd_n = _forward(TRAIN_B, s, c, dtype, seed)
        bwd, bwd_n = _backward(TRAIN_B, s, c, dtype, seed)
        serve, serve_n = _forward(SERVE_B, s, c, dtype, seed)
        (lib_fwd, _), (lib_bwd, _) = _library(TRAIN_B, s, c, dtype, seed)
        row = dict(s=s, c=c, resnet_sites=resnets, out_sites=outs,
                   fwd_dev=fwd, fwd_launches=fwd_n, bwd_dev=bwd,
                   bwd_launches=bwd_n, serve_fwd_dev=serve,
                   serve_fwd_launches=serve_n, library_fwd_dev=lib_fwd,
                   library_bwd_dev=lib_bwd)
        rows.append(row)
        print(json.dumps(row), flush=True)
        fwd_calls, sites = 2 * resnets + outs, resnets + outs
        totals["train_fwd"] += fwd_calls * fwd
        totals["train_bwd"] += sites * bwd
        totals["serve_fwd"] += sites * serve
        totals["library_train_fwd"] += fwd_calls * lib_fwd
        totals["library_train_bwd"] += sites * lib_bwd
        totals["train_fwd_launches"] += fwd_calls * fwd_n
        totals["train_bwd_launches"] += sites * bwd_n
        torch.cuda.empty_cache()
    print(json.dumps({"label": label, "dtype": str(dtype), **totals}),
          flush=True)
    if out_path is not None:
        Path(out_path).write_text(json.dumps(
            {"label": label, "card": smi, "rows": rows, "totals": totals},
            indent=1))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    main(*(sys.argv[1:3] or ["run"]))
