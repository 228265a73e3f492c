"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing what it found:

1. environment: the card's name and power limit, torch/CUDA/Triton/nvcc;
   fails at once when no CUDA device is present;
2. build: compiles the six CUDA sources (one ``nvcc`` each, all started
   together) and the Triton probe;
3. every kernel against its plain PyTorch version at the main paths'
   shapes, with max errors, median CUDA-event times and device times of
   both, and the rate: the GN+SiLU forward (bf16, fp16, fp32; its
   statistics too) and backward (at the b4 training step's sites, fp16
   and fp32), each one launch a call and bit-equal on a second launch,
   beside ATen's ``F.group_norm`` + ``F.silu`` (two library calls), the
   flash forward (a
   second launch bit-equal to the first; each serving attention site
   reported in the kernel line's ``sites``), the flash backward (dq and
   dk/dv, bit-equal on a second launch), the fused bf16-SR AdamW
   (``torch.equal`` to plain) and the startup probe; the flash kernels of
   the other precisions, fp16 (the Hopper kernels' second instantiation)
   and fp32 (``csrc/flash_f32.cu`` forward, ``csrc/flash_bwd_f32.cu``
   backward, both split-TF32 wgmma), at the four serving sites and, for
   the backward, at B4 S=T=4096 too, and for fp32 at phase 9's four sites
   (b1; the backward also at B4 S=4096 T=77); beside each, its bound
   (``bound_ms``: the larger of its flops over the card's peak for its
   type and its bytes over 3.35 TB/s) and, as a yardstick the port never
   calls, one PyTorch call computing the same function where there is one
   (``library_ms`` per call and ``library_device_ms``, to hold against
   ``device_ms``): SDPA's forward and backward in the same dtype under
   the backend with the least device time for the flash kernels,
   ``torch.add`` for the probe;
4. the full-width SDXL-base UNet (bf16, weights from a seed) at 1024^2,
   batch 2, through the kernels and through the plain versions;
5. serving: ``SDXLPipeline.from_model`` and one text-to-image call at
   1024x1024, with per-phase times and the kernels' launches;
6. training: the default ``Config()`` (ddpm, v-prediction, batch 4 at
   1024^2, adamw_bf16 with hash noise, remat "full") through
   ``make_optimizer`` -> ``make_train_step`` -> ``create_train_state`` ->
   3 steps on the full-width UNet, with the loss, grad norm, step-time
   split, peak memory, one profiled step and the kernels' launches;
7. training parity: one forward and backward at batch 1, 1024^2, through
   the kernels and through the plain versions: loss and the relative L2
   of all gradients;
8. fp16: the bf16 model freed, ``SDXLModel.from_config`` with
   ``training.mixed_precision="fp16"`` at full width, one text-to-image
   call at 1024x1024 as in phase 5 (where a value overflows fp16, the
   first module that makes it non-finite, on the kernel and the plain
   path) and one profiled UNet step, then one forward and backward at
   batch 1, 512^2, through the kernels and the plain versions (the fp16
   backward kernels' path);
9. fp32 training: the settings of ``configs/ddpm_512_smoke.yaml``
   (``DDPM_512_SMOKE``) at full SDXL-base width, ``mixed_precision "no"``,
   plain ``adamw``, batch 1 at 512^2: phases 6 and 7 on that model, with
   PyTorch's TF32 switches logged (PyTorch's default puts cuDNN's fp32
   convolutions in TF32; ``SDXLModel.create`` turns both switches off);
10. the rest of serving, run right after phase 5 on its bf16 base model:
   the checkpoint round trip (``export_diffusers`` with the port's
   safetensors writer into a temporary directory, ``SDXLPipeline.
   from_pretrained`` back: every tensor ``torch.equal``, the key audit
   empty), ``generate.main`` on that directory at 1024^2 (DPM++ 2M,
   DeepCache 2; its PNG read back, then ``--init`` with it at strength
   0.35), and each new mode through the kernels against the plain
   versions (latents within ``SLICE_REL_L2_TOL``): DPM++ 2M, Euler with
   DeepCache 2 (its first call bit-equal to the uncached one), flow
   matching, img2img, inpainting on a seeded full-width 9-channel UNet and
   the base -> refiner handoff on a seeded full-width refiner, each extra
   model freed before the next.  Phase 3 also holds the GN+SiLU forward at
   the refiner's widths (bf16) and the fp32 VAE encoder's, and the bf16
   flash forward at the refiner's attention sites.

The line before the last is a JSON object with one entry per kernel and
dtype (``launches``: the sum over the main paths, ``launches_by_path``:
each path's count, read just after it ran with the counts set to 0 just
before); the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises and the script exits non-zero without that line.
"""
from __future__ import annotations

import functools
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack
from pathlib import Path
from typing import Optional
from unittest import mock

import numpy as np
import torch

SEED = 0
STEPS = 8  # denoising steps of the measured text-to-image call
DEVICE = "cuda"
SIZE = 1024  # image side of the training phases; latents are SIZE // 8
SERVE_SIZE = 1024  # image side of phase 10

GN_SHAPES = (  # (shape, dtype, eps): UNet resnets in each precision,
    # VAE decoder fp32
    ((2, 16384, 320), torch.bfloat16, 1e-5),
    ((2, 4096, 640), torch.bfloat16, 1e-5),
    ((2, 1024, 2560), torch.bfloat16, 1e-5),
    ((2, 4096, 640), torch.float16, 1e-5),
    ((2, 4096, 640), torch.float32, 1e-5),
    ((1, 65536, 512), torch.float32, 1e-6),
    ((1, 1048576, 128), torch.float32, 1e-6),
)
# phase 10's new GN+SiLU sites at 1024^2: the refiner's resnets (bf16, b2;
# C = 384-3072, up to 96 channels a group) and the fp32 VAE encoder's (b1)
# that the decoder's rows above do not cover
REFINER_GN_SHAPES = (
    ((2, 16384, 384), torch.bfloat16, 1e-5),
    ((2, 16384, 768), torch.bfloat16, 1e-5),
    ((2, 16384, 1152), torch.bfloat16, 1e-5),
    ((2, 4096, 1536), torch.bfloat16, 1e-5),
    ((2, 4096, 2304), torch.bfloat16, 1e-5),
    ((2, 1024, 3072), torch.bfloat16, 1e-5),
    ((2, 256, 3072), torch.bfloat16, 1e-5),
)
ENCODER_GN_SHAPES = (
    ((1, 262144, 128), torch.float32, 1e-6),
    ((1, 262144, 256), torch.float32, 1e-6),
    ((1, 65536, 256), torch.float32, 1e-6),
    ((1, 16384, 512), torch.float32, 1e-6),
)
# the refiner's attention sites at 1024^2 (b2): H = 12 at 64^2, 24 at 32^2
# and 16^2 (the mid block), each self- and cross-attention
REFINER_FLASH_SITES = (
    (2, 4096, 4096, 12, 64), (2, 4096, 77, 12, 64),
    (2, 1024, 1024, 24, 64), (2, 1024, 77, 24, 64),
    (2, 256, 256, 24, 64), (2, 256, 77, 24, 64))
FLASH_SHAPES = (  # (B, S, T, heads, D)
    (2, 4096, 4096, 10, 64),
    (2, 1024, 1024, 20, 64),
    (2, 4096, 77, 10, 64),
    (2, 9216, 9216, 10, 64),
    (2, 256, 256, 4, 16),
    (2, 64, 77, 8, 16),
    (2, 1024, 77, 4, 32),
    (2, 1024, 77, 4, 128),
    (2, 1024, 77, 20, 64),
)
# the b2 serving step's attention sites, reported one by one for flash_fwd
FLASH_SITES = ((2, 4096, 4096, 10, 64), (2, 1024, 1024, 20, 64),
               (2, 1024, 77, 20, 64), (2, 4096, 77, 10, 64))
# the fp16 and fp32 kernels: the serving sites, and for the backward the
# b4 training step's S=T=4096 site too
FLASH_DTYPES = (torch.float16, torch.float32)
FLASH_BWD_SITES = FLASH_SITES + ((4, 4096, 4096, 10, 64),)
# phase 9's sites (b1 512^2: 10 blocks at 32^2 latents, 60 at 16^2, each a
# self- and a cross-attention), where the fp32 kernels run on the main path
PHASE9_SITES = ((1, 1024, 1024, 10, 64), (1, 256, 256, 20, 64),
                (1, 1024, 77, 10, 64), (1, 256, 77, 20, 64))
F32_FWD_SITES = FLASH_SITES + PHASE9_SITES
# the fp32 backward also at the b4 T = 77 site
F32_BWD_SITES = FLASH_BWD_SITES + ((4, 4096, 77, 10, 64),) + PHASE9_SITES
FLASH_BWD_SHAPES = (  # (B, S, T, heads, D): the b4 training step's sites
    (4, 4096, 4096, 10, 64),
    (4, 1024, 1024, 20, 64),
    (4, 4096, 77, 10, 64),
    (4, 256, 256, 4, 16),
    (4, 1024, 77, 4, 32),
    (4, 1024, 77, 4, 128),
    (4, 1024, 77, 20, 64),
)
ADAMW_SHAPES = (  # (leaf shape, channels_last, gradient dtype, decay fires)
    ((1280, 1280), False, torch.float32, False),  # attention projection
    ((10240, 1280), False, torch.float32, True),  # GEGLU input projection
    ((640, 640, 3, 3), True, torch.float32, False),  # resnet convolution
    ((1000003,), False, torch.float32, True),  # not a multiple of a block
    ((1280,), False, torch.bfloat16, True),  # a bias, bf16 accumulator
)
GN_BWD_SHAPES = (  # (shape, dtype): the b4 training step's sites in
    # bf16 (C/G = 10, 30, 20, 80), then fp16 and fp32
    ((4, 16384, 320), torch.bfloat16),
    ((4, 16384, 960), torch.bfloat16),
    ((4, 4096, 640), torch.bfloat16),
    ((4, 1024, 2560), torch.bfloat16),
    ((1, 4096, 640), torch.float16),
    ((1, 4096, 320), torch.float32),
)
# max abs error against the fp32-interior plain version: about half an
# output ulp at |y| < 8 for the 16-bit types
GN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
# backward: max abs error over max |plain| of dx, dscale, dbias; fp32 sums
# in another order only, the 16-bit dx rounded once to its type
GN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
              torch.float16: 5e-3}
# flash forward out and lse: the 16-bit kernels round P to their type
# before the P V product, the plain version after normalising; fp32 is the
# Pallas kernels' own bar (tests/test_flash_attention.py)
FLASH_OUT_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
                 torch.float32: 2e-5}
FLASH_LSE_TOL = {torch.bfloat16: 1e-3, torch.float16: 1e-3,
                 torch.float32: 2e-5}
# max abs error over the plain gradient's max magnitude: the 16-bit
# kernels round P and dS to their type for their products, the plain
# backward keeps fp32; the fp32 kernels multiply split TF32 operands
# (products to ~2^-21) where the plain version multiplies in fp32
FLASH_BWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3,
                 torch.float32: 1e-4}
UNET_REL_L2_TOL = 3e-2
SLICE_REL_L2_TOL = 1e-1  # 8 CFG-5 steps compound the UNet's bf16 spread
# phase 10: img2img strength of the kernels-vs-plain case (5 of 8 steps)
# and of the generate.py --init run; the base -> refiner handoff fraction
IMG2IMG_STRENGTH, GENERATE_STRENGTH, HANDOFF = 0.6, 0.35, 0.8
TRAIN_STEPS = 3
# b1 loss and all gradients, kernels against plain: measured 9.4e-4 and
# 4.0e-3 on an H100 (the kernels' bf16 rounding of P and dS, the GN
# kernel's fp32 interior against the plain bf16 one)
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_L2_TOL = 2e-2
# fp16 (phase 8): the loss at 8 times bf16's resolution; the gradients at
# bf16's bar, as this unscaled loss puts them in fp16's subnormal range
# (9.4% of the plain path's elements are 0 on an H100), where fp16 holds
# fewer bits than bf16
F16_LOSS_REL_TOL, F16_GRAD_REL_L2_TOL = 2e-3, TRAIN_GRAD_REL_L2_TOL
# fp32 (phase 9): kernels and plain versions differ in summation order only
F32_LOSS_REL_TOL, F32_GRAD_REL_L2_TOL = 1e-4, 1e-3
F32_SIZE = 512
# configs/ddpm_512_smoke.yaml as a Config.from_dict literal (the card's
# machine has no pyyaml), with model_type "sdxl", as the file's first
# comment says for the real run; its data section sets 512^2 (F32_SIZE)
DDPM_512_SMOKE = {
    "model": {"model_type": "sdxl", "prediction_type": "epsilon",
              "use_ztsnr": False, "sigma_max": 80.0, "min_snr_gamma": None},
    "optimizer": {"optimizer_type": "adamw", "learning_rate": 1.0e-5},
    "training": {"method": "ddpm", "prediction_type": "epsilon",
                 "batch_size": 1, "gradient_accumulation_steps": 1,
                 "num_epochs": 1, "mixed_precision": "no"},
}
PROMPTS = ("a photograph of an astronaut riding a horse",
           "a watercolor painting of a lighthouse at dawn",
           "a close-up of a red fox in the snow",
           "an isometric illustration of a tiny city")
# the main paths' kernel instantiations: route, source, TPU kernel.  A
# name without a suffix is the bf16 one; "_f16" and "_f32" the others.
SRC = "sdxl_training_improvements_tpu_torch/"
TPU = "sdxl_training_improvements_tpu/ops/"
SUFFIX = {torch.bfloat16: "", torch.float16: "_f16", torch.float32: "_f32"}
KERNELS = {}
for _dt, _sfx in SUFFIX.items():
    _fwd, _bwd = (("flash_f32.cu", "flash_bwd_f32.cu")
                  if _dt == torch.float32
                  else ("flash_fwd.cu", "flash_bwd.cu"))
    KERNELS.update({
        "gn_silu_fwd" + _sfx: ("cuda", SRC + "csrc/groupnorm.cu",
                               TPU + "groupnorm.py:110"),
        "gn_silu_bwd" + _sfx: ("cuda", SRC + "csrc/groupnorm.cu",
                               "none: JAX runs the plain VJP, " + TPU
                               + "groupnorm.py:251"),
        "flash_fwd" + _sfx: ("cuda", SRC + "csrc/" + _fwd,
                             TPU + "flash_attention.py:49"),
        "flash_bwd_dq" + _sfx: ("cuda", SRC + "csrc/" + _bwd,
                                TPU + "flash_attention.py:115"),
        "flash_bwd_dkv" + _sfx: ("cuda", SRC + "csrc/" + _bwd,
                                 TPU + "flash_attention.py:145")})
KERNELS.update({
    "fused_adamw": ("cuda", SRC + "csrc/fused_adamw.cu",
                    TPU + "fused_adamw.py:53"),
    "probe": ("triton", SRC + "ops/probe.py", TPU + "probe.py:106")})
# the kernels each main path launches (the VAE's GroupNorm is fp32)
SERVING_KERNELS = ("gn_silu_fwd", "gn_silu_fwd_f32", "flash_fwd")
TRAIN_KERNELS = ("gn_silu_fwd", "gn_silu_bwd", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv", "fused_adamw")
F16_SERVING_KERNELS = ("gn_silu_fwd_f16", "gn_silu_fwd_f32", "flash_fwd_f16")
F16_TRAIN_KERNELS = ("gn_silu_fwd_f16", "gn_silu_bwd_f16", "flash_fwd_f16",
                     "flash_bwd_dq_f16", "flash_bwd_dkv_f16")
F32_TRAIN_KERNELS = ("gn_silu_fwd_f32", "gn_silu_bwd_f32", "flash_fwd_f32",
                     "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
# the card's peaks (H100 SXM data sheet, dense): bf16 and fp16 tensor
# cores, fp32 outside them (the elementwise kernels' units), device memory
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# fp32-accurate products on the tensor cores: each operand split into two
# TF32 parts, three TF32 products (hi*hi, hi*lo, lo*hi) per fp32 one, at
# the 495 TFLOP/s dense TF32 rate: the least time of the fp32 flash rows
PEAK_TF32_SPLIT = 495e12 / 3
PEAK = {torch.bfloat16: PEAK_BF16, torch.float16: PEAK_BF16,
        torch.float32: PEAK_TF32_SPLIT}


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate and the bytes (each input read once,
    each output written once) over the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def time_ms(fn, warmup: int = 3, iters: int = 10, repeats: int = 5
            ) -> float:
    """Per-call time of back-to-back calls (CUDA events around a loop of
    ``iters``), median over ``repeats`` loops, after warm-up.  Where the
    host cannot launch faster than the device runs, this includes it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int = 10, tries: int = 3):
    """Device time per call: the kernels' own time summed by
    ``torch.profiler``.  A window in which the profiler records no device
    time (it happens now and then) is profiled again, up to ``tries``
    times; None if none records any."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages())
        if total_us > 0:
            return total_us / iters / 1e3
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_environment() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    import triton
    log(f"triton {triton.__version__}")
    from sdxl_training_improvements_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(nvcc.stdout.strip().splitlines()[-1])
    log(f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi.stdout.strip()


def phase_build() -> None:
    from sdxl_training_improvements_tpu_torch.ops import _build
    from sdxl_training_improvements_tpu_torch.ops.groupnorm import (
        gn_silu_fwd_cuda)
    from sdxl_training_improvements_tpu_torch.ops.probe import probe_cuda
    t0 = time.perf_counter()
    _build.build_all(_build.KERNELS)
    for name in _build.KERNELS:
        _build.load(name)
    t1 = time.perf_counter()
    x = torch.randn(1, 64, 64, device="cuda")
    gn_silu_fwd_cuda(x, torch.ones(64, device="cuda"),
                     torch.zeros(64, device="cuda"), 32)
    probe_cuda(x)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"build: nvcc {', '.join(_build.KERNELS)} in parallel "
        f"{t1 - t0:.2f} s, first GN + Triton probe launches {t2 - t1:.2f} s")


def _gn_inputs(shape, dtype, gen):
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=DEVICE) * 1.5 + 1.0
         ).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    bias = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    return x, scale, bias


def _gn_library(x, scale, bias, eps, dy=None):
    """(ms, device ms) of ATen's F.group_norm then F.silu (two library
    calls, a yardstick the port never calls) on x's values laid out
    [B, C, S], parameters in x's dtype: the forward, or with ``dy`` the
    backward (``torch.autograd.grad`` of one output)."""
    f = torch.nn.functional
    xn = x.transpose(1, 2).contiguous()
    sc, bi = scale.to(x.dtype), bias.to(x.dtype)
    if dy is None:
        def call():
            with torch.no_grad():
                return f.silu(f.group_norm(xn, 32, sc, bi, eps))
    else:
        leaves = [t.detach().requires_grad_() for t in (xn, sc, bi)]
        xl, sl, bl = leaves
        call = functools.partial(
            torch.autograd.grad, f.silu(f.group_norm(xl, 32, sl, bl, eps)),
            leaves, dy.transpose(1, 2).contiguous(), retain_graph=True)
    return time_ms(call), device_ms(call)


def _gn_case(shape, dtype, eps, gen):
    """The forward kernel against the plain version: y, and its mean and
    rstd against the two-pass statistics; one launch a call, a second
    launch bit-equal."""
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    x, scale, bias = _gn_inputs(shape, dtype, gen)
    before = G.gn_silu_fwd_cuda.launches
    got = G.gn_silu_fwd_cuda(x, scale, bias, 32, eps)
    launches = G.gn_silu_fwd_cuda.launches - before
    again = G.gn_silu_fwd_cuda(x, scale, bias, 32, eps)
    rerun_equal = all(torch.equal(a, a2) for a, a2 in zip(got, again))
    out, k_mean, k_rstd = got
    del again, got
    mean, rstd = G.group_stats_reference(x, 32, eps)
    stats_err = max((k_mean - mean).abs().max().item(),
                    (k_rstd - rstd).abs().max().item())
    # against the fp32-interior plain version on the same values (for
    # bf16: the rounding of the output is the error)
    ref = G.groupnorm_silu_reference(x.float(), scale, bias, 32, eps)
    err = (out.float() - ref).abs().max().item()
    del out, ref

    def kernel():
        return G.gn_silu_fwd_cuda(x, scale, bias, 32, eps)

    def plain():
        return G.groupnorm_silu_reference(x, scale, bias, 32, eps)

    res = dict(shape=shape, dtype=dtype, err=err, stats_err=stats_err,
               ms=time_ms(kernel), plain_ms=time_ms(plain),
               dev_ms=device_ms(kernel), plain_dev_ms=device_ms(plain))
    res["library_ms"], res["library_dev"] = _gn_library(x, scale, bias, eps)
    log(f"gn_silu_fwd {list(shape)} {str(dtype)[6:]} eps={eps:g}: "
        f"max_abs_err {err:.3e} (tol {GN_TOL[dtype]:g}), stats (mean, "
        f"rstd) max_abs_err {stats_err:.3e}, launches {launches}, rerun "
        f"bit-equal {rerun_equal}; per call kernel {res['ms']:.4f} ms vs "
        f"plain {res['plain_ms']:.4f} ms; device time kernel "
        f"{fmt_ms(res['dev_ms'])} vs plain {fmt_ms(res['plain_dev_ms'])}; "
        f"F.group_norm + F.silu {fmt_ms(res['library_ms'])} (device "
        f"{fmt_ms(res['library_dev'])})")
    check(err <= GN_TOL[dtype], f"gn_silu_fwd {shape} {dtype}: {err}")
    check(stats_err <= 1e-4, f"gn_silu stats {shape} {dtype}: {stats_err}")
    check(launches == 1, f"gn_silu_fwd {shape}: {launches} launches")
    check(rerun_equal, f"gn_silu_fwd {shape} {dtype}: a second launch "
          "differs from the first")
    torch.cuda.empty_cache()
    return res


def _gn_bwd_case(shape, dtype, gen):
    """The backward kernel against the closed-form plain backward on the
    forward kernel's statistics: dx, dscale, dbias; one launch a call, a
    second launch bit-equal."""
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    x, scale, bias = _gn_inputs(shape, dtype, gen)
    dy = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    _, mean, rstd = G.gn_silu_fwd_cuda(x, scale, bias, 32, 1e-5)
    args = (dy, x, scale, bias, mean, rstd, 32)
    before = G.gn_silu_bwd_cuda.launches
    got = G.gn_silu_bwd_cuda(*args)
    launches = G.gn_silu_bwd_cuda.launches - before
    again = G.gn_silu_bwd_cuda(*args)
    rerun_equal = all(torch.equal(a, a2) for a, a2 in zip(got, again))
    del again
    ref = G.groupnorm_silu_backward_reference(*args)
    err, rel = {}, {}
    for name, a, r in zip(("dx", "dscale", "dbias"), got, ref):
        err[name] = (a.float() - r.float()).abs().max().item()
        rel[name] = err[name] / r.float().abs().max().item()
    del got, ref
    res = dict(shape=shape, dtype=dtype, err=err, rel=rel,
               ms=time_ms(lambda: G.gn_silu_bwd_cuda(*args)),
               dev_ms=device_ms(lambda: G.gn_silu_bwd_cuda(*args)),
               plain_ms=time_ms(lambda: G.groupnorm_silu_backward_reference(
                   *args), warmup=1, iters=3, repeats=3),
               plain_dev_ms=device_ms(
                   lambda: G.groupnorm_silu_backward_reference(*args),
                   iters=3))
    res["library_ms"], res["library_dev"] = _gn_library(x, scale, bias,
                                                        1e-5, dy)
    tol = GN_BWD_TOL[dtype]
    what = f"gn_silu_bwd {list(shape)} {str(dtype)[6:]}"
    log(f"{what}: max_abs_err dx {err['dx']:.3e} dscale "
        f"{err['dscale']:.3e} dbias {err['dbias']:.3e}, over max |plain| "
        f"{max(rel.values()):.3e} (tol {tol:g}), launches {launches}, "
        f"rerun bit-equal {rerun_equal}; per call kernel {res['ms']:.4f} ms "
        f"vs plain {res['plain_ms']:.4f} ms; device time kernel "
        f"{fmt_ms(res['dev_ms'])} vs plain {fmt_ms(res['plain_dev_ms'])}; "
        f"F.group_norm + F.silu backward {fmt_ms(res['library_ms'])} "
        f"(device {fmt_ms(res['library_dev'])})")
    check(max(rel.values()) <= tol, f"{what}: {rel}")
    check(launches == 1, f"{what}: {launches} launches")
    check(rerun_equal, f"{what}: a second launch differs from the first")
    torch.cuda.empty_cache()
    return res


def sdpa_ms(q, k, v, dout=None):
    """(ms, backend, device ms) of SDPA's flash, cuDNN or efficient
    backend, whichever has the least device time (``device_ms``, the
    measure the port's kernels are held to), on [B, H, S, D] views made
    before the timers start: the forward, or with ``dout`` the backward
    (``torch.autograd.grad`` of one output).  ms is that backend's per-call
    time (``time_ms``).  A yardstick only: the port never calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    found = {}  # backend -> (ms, device ms)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        with sdpa_kernel(backend):
            try:
                if dout is None:
                    call = functools.partial(sdpa, qt, kt, vt)
                    found[backend.name] = (time_ms(call), device_ms(call))
                    continue
                leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
                call = functools.partial(
                    torch.autograd.grad, sdpa(*leaves), leaves,
                    dout.transpose(1, 2), retain_graph=True)
                found[backend.name] = (time_ms(call), device_ms(call))
                del call, leaves
            except RuntimeError:  # this backend does not take the shape
                continue
    if not found:
        return None, None, None
    best = min(found, key=lambda name: found[name][1] or float("inf"))
    return found[best][0], best, found[best][1]


def _timers(slow: bool):
    """(time_ms, device_ms) keyword arguments: fewer calls for a kernel
    that takes tens of ms (the fp32 ones at the larger sites)."""
    return ((dict(warmup=1, iters=3, repeats=3), dict(iters=3)) if slow
            else ({}, {}))


def _flash_case(b, s, t, h, d, gen, dtype=torch.bfloat16):
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=DEVICE
                           ).to(dtype) for n in (s, t, t))
    out, lse = F.flash_attention_fwd_cuda(q, k, v)
    out2, lse2 = F.flash_attention_fwd_cuda(q, k, v)
    rerun_equal = torch.equal(out, out2) and torch.equal(lse, lse2)
    del out2, lse2
    ref, ref_lse = F.flash_attention_fwd_reference(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    del out, lse, ref, ref_lse
    kw, dkw = _timers(dtype == torch.float32)
    ms = time_ms(lambda: F.flash_attention_fwd_cuda(q, k, v), **kw)
    plain_ms = time_ms(lambda: F.flash_attention_fwd_reference(q, k, v),
                       warmup=1, iters=2, repeats=3)
    dev = device_ms(lambda: F.flash_attention_fwd_cuda(q, k, v), **dkw)
    plain_dev = device_ms(lambda: F.flash_attention_fwd_reference(q, k, v),
                          iters=2)
    flops = 4 * b * h * s * t * d
    tflops = flops / (ms * 1e-3) / 1e12
    lib_ms, lib, lib_dev = sdpa_ms(q, k, v)
    size = q.element_size()
    bound_ms, bound_by = bound(
        flops, size * (2 * s + 2 * t) * b * h * d + 4 * b * h * s,
        PEAK[dtype])
    dev_tflops = (f"{flops / (dev * 1e-3) / 1e12:.1f}" if dev
                  else "not measured")
    out_tol, lse_tol = FLASH_OUT_TOL[dtype], FLASH_LSE_TOL[dtype]
    what = f"flash_fwd {str(dtype)[6:]} B={b} S={s} T={t} H={h} D={d}"
    log(f"{what}: out max_abs_err {err:.3e} (tol {out_tol:g}), lse "
        f"{lse_err:.3e} (tol {lse_tol:g}), rerun bit-equal {rerun_equal}; "
        f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s; device {fmt_ms(dev)}, "
        f"{dev_tflops} TFLOP/s) vs plain {plain_ms:.4f} ms (device "
        f"{fmt_ms(plain_dev)}); bound {bound_ms:.4f} ms ({bound_by}); SDPA "
        f"({lib}) {fmt_ms(lib_ms)} (device {fmt_ms(lib_dev)})")
    check(err <= out_tol, f"{what}: out {err}")
    check(lse_err <= lse_tol, f"{what}: lse {lse_err}")
    check(rerun_equal, f"{what}: a second launch differs from the first")
    torch.cuda.empty_cache()
    return dict(shape=(b, s, t, h, d), err=max(err, lse_err), ms=ms,
                plain_ms=plain_ms, dev=dev, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, library=lib,
                library_dev=lib_dev)


def _flash_bwd_case(b, s, t, h, d, gen, dtype=torch.bfloat16):
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    q, k, v, dout = (torch.randn((b, n, h, d), generator=gen, device=DEVICE
                                 ).to(dtype) for n in (s, t, t, s))
    out, lse = F.flash_attention_fwd_cuda(q, k, v)
    scale = d ** -0.5
    delta = F.flash_attention_bwd_delta(out, dout)
    args = (q, k, v, dout, lse, delta, scale)
    # max|dO| (fp16: the kernels' dS factor) once, as the backward forms it
    kargs = args + (F.dout_absmax(dout),)
    got = (F.flash_bwd_dq_cuda(*kargs), *F.flash_bwd_dkv_cuda(*kargs))
    again = (F.flash_bwd_dq_cuda(*kargs), *F.flash_bwd_dkv_cuda(*kargs))
    rerun_equal = all(torch.equal(a, a2) for a, a2 in zip(got, again))
    del again
    ref = (F.flash_bwd_dq_reference(*args),
           *F.flash_bwd_dkv_reference(*args))
    err, rel = {}, {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err[name] = (a.float() - r.float()).abs().max().item()
        rel[name] = err[name] / r.float().abs().max().item()
    del got, ref
    res = dict(shape=(b, s, t, h, d), err=err, rel=rel)
    kw, dkw = _timers(dtype == torch.float32)
    for name, kernel, plain in (
            ("dq", F.flash_bwd_dq_cuda, F.flash_bwd_dq_reference),
            ("dkv", F.flash_bwd_dkv_cuda, F.flash_bwd_dkv_reference)):
        res[f"{name}_ms"] = time_ms(lambda: kernel(*kargs), **kw)
        res[f"{name}_dev"] = device_ms(lambda: kernel(*kargs), **dkw)
        res[f"plain_{name}_ms"] = time_ms(lambda: plain(*args), warmup=1,
                                          iters=2, repeats=3)
        res[f"plain_{name}_dev"] = device_ms(lambda: plain(*args), iters=2)
    res["delta_ms"] = time_ms(lambda: F.flash_attention_bwd_delta(out, dout))
    res["library_ms"], res["library"], res["library_dev"] = sdpa_ms(
        q, k, v, dout)
    work = b * h * s * t * d  # 6 flops per unit in dq, 8 in dk/dv
    # bytes: q, k, v, dO and lse, Delta fp32 read; dq or dk, dv written
    size = q.element_size()
    read = size * (2 * s + 2 * t) * b * h * d + 8 * b * h * s
    res["dq_bound"] = bound(6 * work, read + size * b * s * h * d,
                            PEAK[dtype])
    res["dkv_bound"] = bound(8 * work, read + 2 * size * b * t * h * d,
                             PEAK[dtype])
    torch.cuda.empty_cache()
    dq_tf = 6 * work / (res["dq_ms"] * 1e-3) / 1e12
    dkv_tf = 8 * work / (res["dkv_ms"] * 1e-3) / 1e12
    pair_tf = 14 * work / ((res["dq_ms"] + res["dkv_ms"]) * 1e-3) / 1e12
    tol = FLASH_BWD_TOL[dtype]
    what = f"flash_bwd {str(dtype)[6:]} B={b} S={s} T={t} H={h} D={d}"
    log(f"{what}: max_abs_err dq "
        f"{err['dq']:.3e} dk {err['dk']:.3e} dv {err['dv']:.3e}, over max "
        f"|plain| {max(rel.values()):.3e} (tol {tol:g}), rerun bit-equal "
        f"{rerun_equal}; dq kernel "
        f"{res['dq_ms']:.4f} ms ({dq_tf:.1f} TFLOP/s; device "
        f"{fmt_ms(res['dq_dev'])}) vs plain {res['plain_dq_ms']:.4f} ms "
        f"(device {fmt_ms(res['plain_dq_dev'])}); dkv kernel "
        f"{res['dkv_ms']:.4f} ms ({dkv_tf:.1f} TFLOP/s; device "
        f"{fmt_ms(res['dkv_dev'])}) vs plain {res['plain_dkv_ms']:.4f} ms "
        f"(device {fmt_ms(res['plain_dkv_dev'])}); pair {pair_tf:.1f} "
        f"TFLOP/s; bounds dq {res['dq_bound'][0]:.4f} dkv "
        f"{res['dkv_bound'][0]:.4f} ms; dq + dkv + Delta "
        f"{res['dq_ms'] + res['dkv_ms'] + res['delta_ms']:.4f} ms vs SDPA "
        f"backward ({res['library']}) {fmt_ms(res['library_ms'])} (device "
        f"{fmt_ms(res['library_dev'])})")
    check(max(rel.values()) <= tol, f"{what}: {rel}")
    check(rerun_equal, f"{what}: a second launch differs from the first")
    return res


def _adamw_case(shape, channels_last, g_dtype, fires, gen):
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O

    def randn(scale):
        x = scale * torch.randn(shape, generator=gen, device="cuda")
        return (x.contiguous(memory_format=torch.channels_last)
                if channels_last else x)

    p, g, m = randn(0.05).bfloat16(), randn(1e-3).to(g_dtype), \
        randn(1e-4).bfloat16()
    v = (1e-8 * randn(1.0).square()).bfloat16()
    shift = randn(1e-7).bfloat16()
    kw = dict(lr_eff=1e-4 * (1 - 0.999 ** 3) ** 0.5,
              decay_amt=5.02e-3 if fires else 0.0, seed0=0x9E3779B9,
              seed1=0x7F4A7C15)
    ref = O.fused_adamw_reference(p, g, m, v, shift, **kw)
    got = O.fused_adamw_cuda(p, g, m.clone(), v.clone(), shift.clone(), **kw)
    equal = {name: torch.equal(a, r) and a.stride() == r.stride()
             for name, a, r in zip(("delta", "m", "v", "shift"), got, ref)}
    err = max((a.float() - r.float()).abs().max().item()
              for a, r in zip(got, ref))
    state = [m.clone(), v.clone(), shift.clone()]
    res = dict(
        err=err, equal=all(equal.values()),
        ms=time_ms(lambda: O.fused_adamw_cuda(p, g, *state, **kw)),
        dev=device_ms(lambda: O.fused_adamw_cuda(p, g, *state, **kw)),
        plain_ms=time_ms(lambda: O.fused_adamw_reference(
            p, g, m, v, shift, **kw), warmup=1, iters=3, repeats=3),
        plain_dev=device_ms(lambda: O.fused_adamw_reference(
            p, g, m, v, shift, **kw), iters=3))
    # bytes per parameter: p, m, v, shift (bf16) and g read; delta, m, v,
    # shift (bf16) written
    moved = 16 + g.element_size()
    gbps = moved * p.numel() / (res["ms"] * 1e-3) / 1e9
    plain_gbps = moved * p.numel() / (res["plain_ms"] * 1e-3) / 1e9
    log(f"fused_adamw {list(shape)}{' channels_last' if channels_last else ''}"
        f" g {str(g_dtype)[6:]} decay {'fires' if fires else 'off'}: "
        f"torch.equal to plain {equal}, max_abs_err {err:.3e}; kernel "
        f"{res['ms']:.4f} ms ({gbps:.1f} GB/s at {moved} B/param, "
        f"{gbps / 3350:.3f} of 3.35 TB/s; device {fmt_ms(res['dev'])}) vs "
        f"plain {res['plain_ms']:.4f} ms ({plain_gbps:.1f} GB/s; device "
        f"{fmt_ms(res['plain_dev'])})")
    check(res["equal"], f"fused_adamw {shape}: not equal to plain {equal}")
    return res


def _probe_case():
    from sdxl_training_improvements_tpu_torch.ops import probe as P
    res = P.run_probe()
    x = torch.linspace(-1.0, 1.0, P.PROBE_SHAPE[0] * P.PROBE_SHAPE[1],
                       device="cuda").reshape(P.PROBE_SHAPE)
    res["dev"] = device_ms(lambda: P.probe_cuda(x))
    res["plain_dev"] = device_ms(lambda: P.probe_reference(x))
    one = torch.ones((), device="cuda")
    res["library_ms"] = time_ms(lambda: torch.add(one, x, alpha=2.0))
    res["library_dev"] = device_ms(lambda: torch.add(one, x, alpha=2.0))
    log(f"probe {list(P.PROBE_SHAPE)} fp32 x*2+1: max_abs_err "
        f"{res['max_abs_err']:.3e} (tol 0); kernel {res['ms']:.4f} ms "
        f"({res['gbps']:.1f} GB/s; device {fmt_ms(res['dev'])}) vs plain "
        f"{res['plain_ms']:.4f} ms ({res['plain_gbps']:.1f} GB/s; device "
        f"{fmt_ms(res['plain_dev'])}); torch.add(1, x, alpha=2) "
        f"{res['library_ms']:.4f} ms (device {fmt_ms(res['library_dev'])})")
    check(res["max_abs_err"] == 0.0, f"probe error {res['max_abs_err']}")
    return res


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = dict(
        gn=[_gn_case(shape, dt, eps, gen) for shape, dt, eps in
            GN_SHAPES + REFINER_GN_SHAPES + ENCODER_GN_SHAPES],
        gn_bwd=[_gn_bwd_case(shape, dt, gen) for shape, dt in GN_BWD_SHAPES],
        flash=[_flash_case(*shape, gen)
               for shape in FLASH_SHAPES + REFINER_FLASH_SITES],
        flash_bwd=[_flash_bwd_case(*shape, gen)
                   for shape in FLASH_BWD_SHAPES],
        adamw=[_adamw_case(*case, gen) for case in ADAMW_SHAPES],
        probe=_probe_case())
    for dt in FLASH_DTYPES:
        res["flash" + SUFFIX[dt]] = [
            _flash_case(*shape, gen, dtype=dt)
            for shape in (F32_FWD_SITES if dt == torch.float32
                          else FLASH_SITES)]
        res["flash_bwd" + SUFFIX[dt]] = [
            _flash_bwd_case(*shape, gen, dtype=dt)
            for shape in (F32_BWD_SITES if dt == torch.float32
                          else FLASH_BWD_SITES)]
    torch.cuda.empty_cache()
    return res


def _plain_ops():
    """Patch the model layers onto the plain versions (the comparison run
    of phase 4; the package itself has no such switch)."""
    from sdxl_training_improvements_tpu_torch.models import layers
    from sdxl_training_improvements_tpu_torch.ops import attention, groupnorm
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        layers, "groupnorm_silu", groupnorm.groupnorm_silu_reference))
    stack.enter_context(mock.patch.object(
        layers, "dot_product_attention",
        attention.dot_product_attention_reference))
    return stack


def _host_ms(fn, repeats: int = 3) -> float:
    """Median wall time of a call that ends in a synchronize."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_unet(model) -> dict:
    """Full-width UNet at 1024^2, batch 2: kernels against plain."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ucfg = model.unet_config
    args = (randn(2, 4, 128, 128), torch.tensor([500, 500], device="cuda"),
            randn(2, 77, ucfg.cross_attention_dim).bfloat16(),
            randn(2, ucfg.pooled_embed_dim).bfloat16(),
            torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2,
                         device="cuda"))
    with torch.inference_mode():
        out = model.unet_apply(*args).float()
        ms = _host_ms(lambda: model.unet_apply(*args))
        with _plain_ops():
            ref = model.unet_apply(*args).float()
            plain_ms = _host_ms(lambda: model.unet_apply(*args))
    rel = ((out - ref).norm() / ref.norm()).item()
    log(f"unet 1024^2 b2 bf16: output {list(out.shape)}, finite "
        f"{bool(torch.isfinite(out).all())}, |ref| rms "
        f"{ref.pow(2).mean().sqrt().item():.4g}; kernel path vs plain rel "
        f"L2 {rel:.3e} (tol {UNET_REL_L2_TOL:g}); forward {ms:.2f} ms "
        f"vs plain {plain_ms:.2f} ms")
    check(bool(torch.isfinite(out).all()), "unet output not finite")
    check(rel <= UNET_REL_L2_TOL, f"unet kernel path rel L2 {rel}")
    return dict(rel_l2=rel, ms=ms, plain_ms=plain_ms)


def _kernel_group(name: str) -> str:
    n = name.lower()
    for group, keys in (("flash_fwd (hand CUDA)", ("flash_fwd",
                                                   "flash_f32_fwd")),
                        ("flash_bwd (hand CUDA)", ("flash_bwd",
                                                   "dkv_reduce",
                                                   "flash_f32_dq",
                                                   "flash_f32_dkv")),
                        ("fused_adamw (hand CUDA)", ("fused_adamw",)),
                        ("gn_silu (hand CUDA)", ("gn_silu",)),
                        ("convolution", ("conv", "fprop", "implicit",
                                         "nhwc", "dgrad", "wgrad")),
                        ("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
                        ("norm/softmax", ("norm", "softmax", "welford",
                                          "reduce")),
                        ("elementwise/copy", ("elementwise", "copy",
                                              "vectorized", "cat",
                                              "upsample", "index"))):
        if any(k in n for k in keys):
            return group
    return "other"


def _log_profile(prof, what: str, wall_ms: float) -> float:
    """Log device busy time by kernel group and the idle share of a
    profiled window of ``wall_ms``; returns the idle share."""
    groups: dict = {}
    launches = 0
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
        launches += e.count
    busy = sum(groups.values())
    idle = 1 - busy / wall_ms
    log(f"{what} profile: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {idle:.3f}, {launches} kernel launches")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {ms:.2f} ms ({ms / busy:.3f})")
    return idle


def profile_unet_step(model, label: str = "unet step",
                      shallow: bool = False) -> None:
    """Where one denoising step's time goes: device time of one CFG
    forward (b2, 1024^2) by kernel group, and the device's idle share;
    with ``shallow``, of a DeepCache shallow forward around the deep
    feature of a full one."""
    from torch.profiler import ProfilerActivity, profile
    ucfg = model.unet_config
    args = (torch.zeros(2, ucfg.in_channels, 128, 128, device="cuda"),
            torch.tensor([500, 500], device="cuda"),
            torch.zeros(2, 77, ucfg.cross_attention_dim, device="cuda"),
            torch.zeros(2, ucfg.pooled_embed_dim, device="cuda"),
            torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024][
                :ucfg.num_time_ids]] * 2, device="cuda"))
    with torch.inference_mode():
        kw = {}
        if shallow:
            kw["deep_cache"] = model.unet_apply(*args, return_deep=True)[1]
        model.unet_apply(*args, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.unet_apply(*args, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    _log_profile(prof, f"{label} (b2 1024^2)", wall_ms)


def _timed(fn, record):
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t0) * 1e3, a))
        return result
    return wrapper


def _counters() -> dict:
    """Each kernel instantiation of the main paths, by the name it is
    reported under, to a function reading its launch count."""
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    from sdxl_training_improvements_tpu_torch.ops import probe as P
    counters = {"fused_adamw": lambda: O.fused_adamw_cuda.launches,
                "probe": lambda: P.probe_cuda.launches}
    for dt, sfx in SUFFIX.items():
        counters.update({
            "gn_silu_fwd" + sfx: functools.partial(
                G.gn_silu_fwd_cuda.launches_by_dtype.__getitem__, dt),
            "gn_silu_bwd" + sfx: functools.partial(
                G.gn_silu_bwd_cuda.launches_by_dtype.__getitem__, dt),
            **{name + sfx: functools.partial(
                getattr, F.LAUNCHERS[kind][dt], "launches")
               for name, kind in (("flash_fwd", "fwd"),
                                  ("flash_bwd_dq", "dq"),
                                  ("flash_bwd_dkv", "dkv"))}})
    return counters


def _zero_launches() -> None:
    """Every kernel wrapper's and launcher's count to 0."""
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    from sdxl_training_improvements_tpu_torch.ops import probe as P
    for w in (F.flash_attention_fwd_cuda, F.flash_bwd_dq_cuda,
              F.flash_bwd_dkv_cuda, O.fused_adamw_cuda, P.probe_cuda,
              G.gn_silu_fwd_cuda, G.gn_silu_bwd_cuda):
        w.launches = 0
    for w in (G.gn_silu_fwd_cuda, G.gn_silu_bwd_cuda):
        w.launches_by_dtype.clear()
    G.gn_silu_bwd_cuda.dy_copies = 0
    for by_dtype in F.LAUNCHERS.values():
        for launcher in by_dtype.values():
            launcher.launches = 0


def _launches(names) -> dict:
    counters = _counters()
    return {k: counters[k]() for k in names}


def _first_nonfinite(calls) -> Optional[tuple]:
    """(call, module) of the first UNet module, in execution order, whose
    output holds a non-finite value over the recorded UNet calls, each
    (model, args, kwargs), else None."""
    names, found, handles = {}, [], []

    def hook(module, inputs, output):
        if (not found and isinstance(output, torch.Tensor)
                and not bool(torch.isfinite(output).all())):
            found.append(names[module])

    for model in {id(m): m for m, _, _ in calls}.values():
        names.update({m: n or "unet" for n, m in model.unet.named_modules()})
        handles += [m.register_forward_hook(hook)
                    for m in model.unet.modules()]
    try:
        with torch.inference_mode():
            for i, (model, args, kw) in enumerate(calls):
                model.unet_apply(*args, **kw)
                if found:
                    return i, found[0]
    finally:
        for h in handles:
            h.remove()
    return None


def phase_slice(model, kernels=SERVING_KERNELS, label: str = "slice",
                size: int = 1024, overflow_ok: bool = False) -> dict:
    """Text-to-image at size x size through the port's pipeline, with the
    launches of ``kernels``.  The latents must be finite, unless
    ``overflow_ok``: then the first UNet module that makes a value
    non-finite on the kernel path and on the plain path is logged, and the
    two must agree (the overflow is the model's, not a kernel's)."""
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    pipe = SDXLPipeline.from_model(model)
    pipe(["warm up"], height=size, width=size, num_inference_steps=2)
    rec = {"clip": [], "unet": [], "vae": []}
    prompt = ["a photograph of an astronaut riding a horse"]
    with ExitStack() as stack:
        for name, attr in (("clip", "encode_prompt"), ("unet", "unet_apply"),
                           ("vae", "decode_latents")):
            stack.enter_context(mock.patch.object(
                model, attr, _timed(getattr(model, attr), rec[name])))
        _zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = pipe(prompt, height=size, width=size,
                      num_inference_steps=STEPS, guidance_scale=5.0,
                      seed=SEED)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = _launches(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    latents = rec["vae"][0][1][0]
    img = images[0]
    step_ms = [t for t, _ in rec["unet"]]
    finite = bool(torch.isfinite(latents).all())
    log(f"{label} {size}x{size} euler {STEPS} steps guidance 5.0: image "
        f"{img.shape} {img.dtype}, latents {list(latents.shape)} finite "
        f"{finite}")
    log(f"{label} times: clip encode {rec['clip'][0][0]:.2f} ms, unet "
        f"{statistics.mean(step_ms):.2f} ms/step over {len(step_ms)} "
        f"calls, vae decode {rec['vae'][0][0]:.2f} ms, total "
        f"{total_s:.3f} s, peak memory {peak_gb:.2f} GiB")
    log(f"{label} kernel launches: {launches}")
    calls = [(model, a, {}) for _, a in rec["unet"]]
    with _plain_ops():
        plain = pipe(prompt, height=size, width=size,
                     num_inference_steps=STEPS, guidance_scale=5.0,
                     seed=SEED, return_latents=True)
        plain_where = (None if bool(torch.isfinite(plain).all())
                       else _first_nonfinite(calls))
    if finite:
        rel = ((latents - plain).norm() / plain.norm()).item()
        log(f"{label} latents, kernel path vs plain path (same seed): rel "
            f"L2 {rel:.3e} (tol {SLICE_REL_L2_TOL:g})")
        check(rel <= SLICE_REL_L2_TOL, f"{label} latents rel L2 {rel}")
    else:
        check(overflow_ok, f"{label}: latents not finite")
        where = _first_nonfinite(calls)
        log(f"{label}: the latents overflow; first non-finite (UNet call, "
            f"module): kernel path {where}, plain path {plain_where}")
        check(where is not None and where == plain_where,
              f"{label}: the kernel path overflows at {where}, the plain "
              f"path at {plain_where}")
    check(img.shape == (size, size, 3) and img.dtype == np.uint8,
          f"image {img.shape} {img.dtype}")
    check(len(step_ms) == STEPS, f"{len(step_ms)} UNet calls")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the {label} path")
    return dict(launches=launches, finite=finite, peak_gb=peak_gb)


# ------------------------------------------------ phase 10: rest of serving
# kernels of each phase-10 path: the UNet's bf16 GN+SiLU and flash
# forward; the paths that encode an image also the VAE's fp32 GN+SiLU
T2I_KERNELS = ("gn_silu_fwd", "flash_fwd")
ENCODE_KERNELS = T2I_KERNELS + ("gn_silu_fwd_f32",)


def _checkpoint_round_trip(model, ckpt: Path) -> None:
    """``export_diffusers`` of the bf16 base with the port's writer, then
    ``SDXLPipeline.from_pretrained``: every tensor equal in value and
    dtype, and the key audit of every component empty."""
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.models import weights as W
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    from sdxl_training_improvements_tpu_torch.training.checkpoints import (
        DIRS, components, export_diffusers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = export_diffusers(ckpt, components(model), Config(),
                              unet_config=model.unet_config)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = SDXLPipeline.from_pretrained(ckpt, dtype=torch.bfloat16,
                                        device=DEVICE)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    unequal, audit, n_tensors = [], {}, 0
    for name, module in components(model).items():
        loaded = getattr(pipe.model, name).state_dict()
        for k, v in module.state_dict().items():
            n_tensors += 1
            if v.dtype != loaded[k].dtype or not torch.equal(v, loaded[k]):
                unequal.append(f"{name}.{k}")
        audit[name] = W.check_bijective(
            module, W.load_safetensors_dir(ckpt / DIRS[name]))
    gib = nbytes / 2 ** 30
    log(f"checkpoint round trip: {gib:.3f} GiB in {n_tensors} tensors "
        f"written in {write_s:.2f} s ({gib / write_s:.2f} GiB/s), "
        f"from_pretrained {read_s:.2f} s ({gib / read_s:.2f} GiB/s); "
        f"tensors not equal: {len(unequal)} {unequal[:3]}; key audit "
        f"(missing, unused) {audit}")
    check(not unequal, f"checkpoint round trip: {unequal[:5]} differ")
    check(all(a == ([], []) for a in audit.values()),
          f"checkpoint key audit {audit}")
    del pipe
    _free()


def _generate(ckpt: Path, out: Path) -> np.ndarray:
    """``generate.main`` on the exported directory: text to image with
    DPM++ 2M and DeepCache 2, then img2img from its PNG; both PNGs read
    back with the port's reader.  Returns the first image."""
    from sdxl_training_improvements_tpu_torch import generate
    from sdxl_training_improvements_tpu_torch.png import read_png
    args = ["--model", str(ckpt), "--prompt", PROMPTS[0], "--height",
            str(SERVE_SIZE), "--width", str(SERVE_SIZE), "--steps",
            str(STEPS), "--seed", str(SEED)]
    images = []
    for extra, sub in ((["--sampler", "dpmpp_2m", "--deep-cache", "2"],
                        "text2img"),
                       (["--init", str(out / "text2img" / "000.png"),
                         "--strength", str(GENERATE_STRENGTH)], "img2img")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = generate.main(args + extra + ["--out", str(out / sub)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        img = read_png(out / sub / "000.png")
        log(f"generate.main {' '.join(extra)}: rc {rc}, {wall:.2f} s (the "
            f"checkpoint load included); PNG read back {img.shape} "
            f"{img.dtype}, mean {img.mean():.2f}")
        check(rc == 0, f"generate.main {extra}: rc {rc}")
        check(img.shape == (SERVE_SIZE, SERVE_SIZE, 3)
              and img.dtype == np.uint8,
              f"generate.main PNG {img.shape} {img.dtype}")
        images.append(img)
        _free()
    return images[0]


def _recorded(models, calls):
    """Patch each model's ``unet_apply`` to record (ms, shallow, model,
    args, kwargs) of every call."""
    stack = ExitStack()
    for model in models:
        def wrapper(*a, _model=model, _apply=model.unet_apply, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _apply(*a, **kw)
            torch.cuda.synchronize()
            calls.append(((time.perf_counter() - t0) * 1e3,
                          kw.get("deep_cache") is not None, _model, a, kw))
            return out
        stack.enter_context(mock.patch.object(model, "unet_apply", wrapper))
    return stack


def _serve_case(label: str, models, run, kernels) -> dict:
    """``run()`` -> latents through the kernels (launches of every serving
    kernel counted from 0, UNet calls timed) and through the plain
    versions with the same seed: the latents' relative L2 within
    ``SLICE_REL_L2_TOL``; where they are not finite, the first module that
    makes them so on each path.  Each of ``kernels`` must launch, the
    flash forward only where a full UNet step ran.  Returns the
    launches."""
    calls: list = []
    with _recorded(models, calls):
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latents = run()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = _launches(SERVING_KERNELS)
    unet_calls = [(m, a, kw) for _, _, m, a, kw in calls]
    with _plain_ops():
        plain = run()
        plain_where = (None if bool(torch.isfinite(plain).all())
                       else _first_nonfinite(unet_calls))
    full = [ms for ms, shallow, *_ in calls if not shallow]
    shallow = [ms for ms, is_shallow, *_ in calls if is_shallow]
    finite = bool(torch.isfinite(latents).all())
    rel = ((latents - plain).norm() / plain.norm()).item() if finite \
        else float("nan")
    log(f"phase 10 {label}: latents {list(latents.shape)} finite {finite}; "
        f"kernel path vs plain (same seed) rel L2 {rel:.3e} (tol "
        f"{SLICE_REL_L2_TOL:g}); {total_s:.3f} s; UNet {len(full)} full "
        f"steps {statistics.mean(full) if full else 0:.2f} ms/step, "
        f"{len(shallow)} shallow "
        f"{statistics.mean(shallow) if shallow else 0:.2f} ms/step; "
        f"launches {launches}")
    if not finite:
        where = _first_nonfinite(unet_calls)
        log(f"phase 10 {label}: first non-finite (UNet call, module): "
            f"kernel path {where}, plain path {plain_where}")
    check(finite, f"phase 10 {label}: latents not finite")
    check(rel <= SLICE_REL_L2_TOL, f"phase 10 {label}: rel L2 {rel}")
    for k in kernels:
        if k == "flash_fwd" and not full:
            continue
        check(launches[k] > 0, f"kernel {k} was not launched on the "
              f"phase 10 {label} path")
    return launches


def _deep_cache_exact(model) -> None:
    """An epsilon walk of one step makes one UNet call, step 0, which
    DeepCache always runs in full: bit-equal to the uncached walk."""
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    eps = NoiseSchedule.create(use_ztsnr=False, sigma_max=80.0,
                               prediction_type="epsilon")
    outs = [SDXLPipeline.from_model(model, schedule=eps, deep_cache=k)(
        PROMPTS[:1], height=SERVE_SIZE, width=SERVE_SIZE,
        num_inference_steps=1, seed=SEED, return_latents=True)
        for k in (1, 3)]
    equal = torch.equal(outs[0], outs[1])
    log(f"phase 10 DeepCache: a 1-step walk with interval 3 bit-equal to "
        f"the uncached walk: {equal}")
    check(equal, "DeepCache's first call differs from the uncached call")


def phase_rest_of_serving(model) -> dict:
    """Phase 10 on the bf16 base model (see the module docstring); returns
    each kernels-vs-plain path's launches."""
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _checkpoint_round_trip(model, Path(tmp) / "ckpt")
        image = _generate(Path(tmp) / "ckpt", Path(tmp) / "out")
    prompt = PROMPTS[:1]
    run = dict(num_inference_steps=STEPS, guidance_scale=5.0, seed=SEED,
               return_latents=True)
    t2i = dict(height=SERVE_SIZE, width=SERVE_SIZE, **run)

    def base(**kw):
        return SDXLPipeline.from_model(model, **kw)

    paths = {
        "dpmpp_2m": _serve_case(
            "dpmpp_2m", [model],
            lambda: base(sampler="dpmpp_2m")(prompt, **t2i), T2I_KERNELS),
        "euler deep-cache 2": _serve_case(
            "euler deep-cache 2", [model],
            lambda: base(deep_cache=2)(prompt, **t2i), T2I_KERNELS),
        "flow matching": _serve_case(
            "flow matching", [model],
            lambda: base(method="flow_matching")(prompt, **t2i),
            T2I_KERNELS),
        "img2img": _serve_case(
            f"img2img strength {IMG2IMG_STRENGTH}", [model],
            lambda: base().img2img(prompt, images=[image],
                                   strength=IMG2IMG_STRENGTH, **run),
            ENCODE_KERNELS)}
    _deep_cache_exact(model)
    profile_unet_step(model, "shallow DeepCache step", shallow=True)

    def seeded(**kw):
        t0 = time.perf_counter()
        extra = SDXLModel.create(
            dtype=torch.bfloat16, device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(SEED + 10),
            **kw)
        torch.cuda.synchronize()
        log(f"phase 10 model {kw['unet_config'].block_out_channels} "
            f"in_channels {kw['unet_config'].in_channels}, refiner "
            f"{extra.clip_l is None}: "
            f"{sum(p.numel() for p in extra.unet.parameters())} UNet "
            f"parameters, {time.perf_counter() - t0:.2f} s")
        return extra

    inpainting = seeded(unet_config=UNetConfig.sdxl_inpainting())
    mask = np.zeros((SERVE_SIZE, SERVE_SIZE), np.uint8)
    mask[SERVE_SIZE // 4:3 * SERVE_SIZE // 4,
         3 * SERVE_SIZE // 8:7 * SERVE_SIZE // 8] = 255
    paths["inpaint"] = _serve_case(
        "inpaint strength 0.8", [inpainting],
        lambda: SDXLPipeline.from_model(inpainting).inpaint(
            prompt, [image], [mask], strength=0.8, **run), ENCODE_KERNELS)
    del inpainting
    _free()
    refiner = seeded(unet_config=UNetConfig.sdxl_refiner(), refiner=True)

    def handoff():
        noisy = base()(prompt, height=SERVE_SIZE, width=SERVE_SIZE,
                       denoising_end=HANDOFF, **run)
        return SDXLPipeline.from_model(refiner).refine(
            prompt, noisy, denoising_start=HANDOFF, **run)

    paths["base -> refiner"] = _serve_case(
        f"base -> refiner at {HANDOFF}", [model, refiner], handoff,
        T2I_KERNELS)
    profile_unet_step(refiner, "refiner step")
    del refiner
    _free()
    log(f"phase 10 wall time {time.perf_counter() - t_phase:.1f} s")
    return paths


def _train_batch(model, n: int, gen, size: int = SIZE) -> dict:
    """A training batch of ``n`` samples at size^2, keyed as the JAX
    trainer's (``methods/__init__.py``): prompt embeddings from the port's
    dual CLIP on a few prompts, seeded latents in place of the VAE encode,
    and SDXL time ids."""
    from sdxl_training_improvements_tpu_torch.models.tokenizer import (
        TokenizerPair)
    tokenizers = TokenizerPair.fallback(vocab_size=model.clip_g.cfg.vocab_size)
    ids_l, ids_g = tokenizers([PROMPTS[i % len(PROMPTS)] for i in range(n)])
    with torch.no_grad():
        enc = model.encode_prompt(
            torch.as_tensor(ids_l, dtype=torch.int64, device=DEVICE),
            torch.as_tensor(ids_g, dtype=torch.int64, device=DEVICE))
    return {"vae_latents": torch.randn(n, 4, size // 8, size // 8,
                                       generator=gen, device=DEVICE),
            "prompt_embeds": enc["prompt_embeds"],
            "pooled_prompt_embeds": enc["pooled_prompt_embeds"],
            "time_ids": torch.tensor([[size, size, 0, 0, size, size]] * n,
                                     dtype=torch.float32, device=DEVICE)}


WATCHED = ("mid_block.attentions.0.transformer_blocks.0.attn1.to_q.weight",
           "down_blocks.0.resnets.0.norm1.weight", "conv_norm_out.bias")


def phase_train(model, cfg, kernels=TRAIN_KERNELS, size: int = SIZE) -> dict:
    """The training slice as the JAX entry drives it: ``make_optimizer`` ->
    ``make_train_step`` -> ``create_train_state`` -> ``TRAIN_STEPS`` steps
    at ``cfg``; the last step runs under the profiler.  Every kernel in
    ``kernels`` must launch in every step."""
    from torch.profiler import ProfilerActivity, profile

    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        create_train_state, make_train_step)
    t = cfg.training
    n = t.batch_size * t.gradient_accumulation_steps
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    batch = _train_batch(model, n, gen, size)
    names = tuple(kernels) + ("probe",)
    _zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    optimizer = make_optimizer(cfg)
    step = make_train_step(model.unet_apply, NoiseSchedule.from_config(cfg),
                           optimizer, cfg)
    state = create_train_state(model.trainable_params(), optimizer,
                               seed=t.seed)
    torch.cuda.synchronize()
    setup_launches = _launches(names)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"train setup ({t.mixed_precision}, {type(optimizer).__name__}): "
        f"{len(state.params)} leaves, {n_params} parameters, "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms (startup probe "
        f"{state.probe['ms']:.4f} ms, {state.probe['gbps']:.1f} GB/s); "
        f"launches {setup_launches}")
    watched = {k: state.params[k].detach().clone() for k in WATCHED}
    steps = []
    for i in range(TRAIN_STEPS):
        before = _launches(names)
        events: dict = {}
        profiled = i == TRAIN_STEPS - 1
        with ExitStack() as stack:
            if profiled:
                prof = stack.enter_context(
                    profile(activities=[ProfilerActivity.CUDA]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, events)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        after = _launches(names)
        row = dict(
            loss=metrics["loss"].item(), grad_norm=metrics["grad_norm"].item(),
            wall_ms=wall_ms,
            fwd_bwd_ms=events["start"].elapsed_time(events["backward"]),
            clip_ms=events["backward"].elapsed_time(events["clip"]),
            opt_ms=events["clip"].elapsed_time(events["update"]),
            launches={k: after[k] - before[k] for k in names})
        steps.append(row)
        log(f"train step {i + 1}{' (profiled)' if profiled else ''}: loss "
            f"{row['loss']:.6f}, grad norm {row['grad_norm']:.6f}; "
            f"{wall_ms:.2f} ms = forward+backward {row['fwd_bwd_ms']:.2f} + "
            f"clip {row['clip_ms']:.2f} + optimizer {row['opt_ms']:.2f} ms "
            f"(CUDA events); launches {row['launches']}")
        if profiled:
            row["idle"] = _log_profile(
                prof, f"train step {i + 1} (b{n} {size}^2)", wall_ms)
        check(np.isfinite(row["loss"]), f"train step {i + 1} loss not finite")
        check(np.isfinite(row["grad_norm"]), f"step {i + 1} grad norm")
        for k in kernels:
            check(row["launches"][k] > 0,
                  f"kernel {k} was not launched in train step {i + 1}")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    changed = {k: int((state.params[k].detach() != v).sum())
               for k, v in watched.items()}
    log(f"train: {TRAIN_STEPS} steps, batch {n} at {size}^2, remat "
        f"{model.unet_config.remat} ({model.unet_config.remat_policy}); "
        f"peak memory {peak_gb:.2f} GiB; elements changed in watched "
        f"leaves {changed}")
    check(all(changed.values()), f"parameters did not change: {changed}")
    check(setup_launches["probe"] > 0, "the startup probe did not launch")
    launches = {k: setup_launches[k] + sum(r["launches"][k] for r in steps)
                for k in names}
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    log(f"train kernel launches (setup + {TRAIN_STEPS} steps): {launches}; "
        f"copies of a non-contiguous dy before the GN backward: "
        f"{G.gn_silu_bwd_cuda.dy_copies}")
    del state, watched, step, optimizer
    torch.cuda.empty_cache()
    return dict(steps=steps, peak_gb=peak_gb, launches=launches)


def phase_train_parity(model, cfg, size: int = SIZE,
                       tols=(TRAIN_LOSS_REL_TOL, TRAIN_GRAD_REL_L2_TOL),
                       kernels=()) -> dict:
    """One forward and backward at batch 1, size^2, with replayed noise
    and timestep, through the kernels and through the plain versions:
    the loss and the relative L2 of all gradients together (within
    ``tols``), and the launches of ``kernels`` on the kernel path."""
    from sdxl_training_improvements_tpu_torch.training.methods import (
        get_method)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    batch = _train_batch(model, 1, gen, size)
    batch["noise"] = torch.randn(1, 4, size // 8, size // 8, generator=gen,
                                 device=DEVICE)
    batch["timesteps"] = torch.tensor([500], device=DEVICE)
    loss_fn = get_method(cfg.training.method)
    schedule = NoiseSchedule.from_config(cfg)
    params = list(model.unet.parameters())

    def loss_and_grads():
        """(loss, gradients, ms of the second of two calls): the first
        call at a new batch size pays allocator growth."""
        for _ in range(2):
            grads = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = loss_fn(model.unet_apply, batch, None, schedule,
                              cfg.model)
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
        return loss.item(), grads, (time.perf_counter() - t0) * 1e3

    _zero_launches()
    loss, grads, ms = loss_and_grads()
    launches = _launches(kernels)
    with _plain_ops():
        plain_loss, plain_grads, plain_ms = loss_and_grads()
    num = sum((a.float() - b.float()).square().sum()
              for a, b in zip(grads, plain_grads))
    den = sum(b.float().square().sum() for b in plain_grads)
    rel = (num / den).sqrt().item()
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    nonzero = sum(int(g.count_nonzero()) for g in plain_grads) / sum(
        g.numel() for g in plain_grads)
    loss_tol, grad_tol = tols
    log(f"train parity ({cfg.training.mixed_precision}, b1 {size}^2, "
        f"t=500): loss kernels {loss:.6f} vs plain {plain_loss:.6f}, rel "
        f"{loss_rel:.3e} (tol {loss_tol:g}); all {len(grads)} gradients rel "
        f"L2 {rel:.3e} (tol {grad_tol:g}), finite {finite}, nonzero share "
        f"of the plain gradients {nonzero:.4f}; warm "
        f"forward+backward {ms:.2f} ms vs plain {plain_ms:.2f} ms; "
        f"launches {launches}")
    check(finite, "train parity: a gradient is not finite")
    check(nonzero > 0, "train parity: the plain gradients are all zero")
    check(loss_rel <= loss_tol, f"train parity loss {loss_rel}")
    check(rel <= grad_tol, f"train parity gradients {rel}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched in the parity run")
    del grads, plain_grads
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_l2=rel, ms=ms, plain_ms=plain_ms,
                launches=launches)


def _free() -> None:
    """After the caller has dropped its references: give the cached memory
    back and restart the peak count."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _model_from_config(raw: dict):
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    cfg = Config.from_dict(raw)
    t0 = time.perf_counter()
    model = SDXLModel.from_config(
        cfg, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"SDXLModel.from_config ({cfg.model.model_type}, mixed_precision "
        f"{cfg.training.mixed_precision!r}) on {DEVICE}: UNet "
        f"{model.unet.conv_in.weight.dtype}, CLIP "
        f"{model.clip_g.text_model.embeddings.token_embedding.weight.dtype}"
        f", VAE "
        f"{next(model.vae.parameters()).dtype}; "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, model


def _nonzero_grads(model, cfg, size: int) -> float:
    """The share of nonzero UNet gradient elements of one forward and
    backward at b1 size^2 under ``cfg``'s loss, through the kernels."""
    from sdxl_training_improvements_tpu_torch.training.methods import (
        get_method)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    batch = _train_batch(model, 1, gen, size)
    loss, _ = get_method(cfg.training.method)(
        model.unet_apply, batch, gen, NoiseSchedule.from_config(cfg),
        cfg.model)
    grads = torch.autograd.grad(loss, list(model.unet.parameters()))
    share = sum(int(g.count_nonzero()) for g in grads) / sum(
        g.numel() for g in grads)
    log(f"fp16 gradients under {cfg.model.prediction_type} (ZTSNR "
        f"{cfg.model.use_ztsnr}, MinSNR {cfg.model.min_snr_gamma}) at b1 "
        f"{size}^2: loss {loss.item():.3e}, nonzero share {share:.4f}")
    return share


def phase_fp16() -> dict:
    """Phase 8: the fp16 model serves one image, then one forward and
    backward at b1 512^2 through the kernels against the plain path.
    Under the default loss (v-prediction, ZTSNR, MinSNR 5) the fp16
    gradients fall below fp16's least subnormal and are all zero, on
    both paths (neither package scales the loss; logged here), so the
    comparison takes the ddpm-epsilon loss of ``DDPM_512_SMOKE``."""
    from sdxl_training_improvements_tpu_torch.config import Config
    cfg, model = _model_from_config({"training": {"mixed_precision": "fp16"}})
    check(model.unet.conv_in.weight.dtype == torch.float16,
          "fp16 policy did not give an fp16 UNet")
    serving = phase_slice(model, F16_SERVING_KERNELS, label="fp16 slice",
                          overflow_ok=True)
    profile_unet_step(model, "fp16 unet step")
    _nonzero_grads(model, cfg, F32_SIZE)
    eps_cfg = Config.from_dict({**DDPM_512_SMOKE, "training": {
        **DDPM_512_SMOKE["training"], "mixed_precision": "fp16"}})
    parity = phase_train_parity(model, eps_cfg, F32_SIZE,
                                (F16_LOSS_REL_TOL, F16_GRAD_REL_L2_TOL),
                                F16_TRAIN_KERNELS)
    del model
    _free()
    return dict(serving=serving, parity=parity,
                launches={**serving["launches"], **parity["launches"]})


def phase_fp32_training() -> dict:
    """Phase 9: the ddpm_512_smoke settings at full width, fp32."""
    cfg, model = _model_from_config(DDPM_512_SMOKE)
    check(model.unet.conv_in.weight.dtype == torch.float32,
          "mixed_precision 'no' did not give an fp32 UNet")
    log(f"fp32 TF32 switches: torch.backends.cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32} (convolutions), "
        f"torch.backends.cuda.matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32} (matmuls)")
    train = phase_train(model, cfg, F32_TRAIN_KERNELS, F32_SIZE)
    parity = phase_train_parity(model, cfg, F32_SIZE,
                                (F32_LOSS_REL_TOL, F32_GRAD_REL_L2_TOL),
                                F32_TRAIN_KERNELS)
    del model
    _free()
    return dict(train=train, parity=parity)


# operations per element of the elementwise kernels, on the fp32 units
# (not the tensor cores): the GN forward (Welford statistics; normalise,
# affine, SiLU), the GN backward (xhat, z, sigmoid, dz and two sums; then
# dx), AdamW (moments, bias corrections, sqrt, divide, decay, stochastic
# rounding), the probe (x * 2 + 1)
OPS_PER_ELEMENT = {"gn_silu_fwd": 12, "gn_silu_bwd": 30, "fused_adamw": 40,
                   "probe": 2}
# elements each GN kernel must read or write once: x and y; x, dy and dx
GN_PASSES = {"gn_silu_fwd": 2, "gn_silu_bwd": 3}


def gn_bound(kind: str, shape, dtype):
    """(least ms, what bounds it) of one GN+SiLU call at ``shape``."""
    n = shape[0] * shape[1] * shape[2]
    size = torch.empty((), dtype=dtype).element_size()
    return bound(OPS_PER_ELEMENT[kind] * n, GN_PASSES[kind] * size * n,
                 PEAK_FP32)


def _gn_sites(kind: str, rows) -> list:
    """Every phase-3 case of one GN kernel and dtype, for its entry."""
    return [{"at": str(list(r["shape"])), "ms": r["ms"],
             "device_ms": r["dev_ms"], "plain_ms": r["plain_ms"],
             "plain_device_ms": r["plain_dev_ms"],
             "bound_ms": gn_bound(kind, r["shape"], r["dtype"])[0],
             "two_library_calls_ms": r["library_ms"],
             "two_library_calls_device_ms": r["library_dev"]}
            for r in rows]


def _site(shape) -> str:
    return "B={} S={} T={} H={} D={}".format(*shape)


def kernel_report(k: dict, paths: dict) -> dict:
    """One entry per kernel instantiation: errors over all of phase 3's
    shapes of its dtype; times, bound and library time at the shape named
    in ``at``; launches summed over the main paths (``paths``: label ->
    launches by kernel) and by path."""
    by_path = {name: {label: counts[name] for label, counts in paths.items()
                      if counts.get(name)} for name in KERNELS}
    measured, device, library_device, extra = {}, {}, {}, {}
    no_library = (None, "none: GroupNorm then SiLU is two library calls "
                  "(two_library_calls)")
    for dt, sfx in SUFFIX.items():
        fwd_rows = [r for r in k["gn"] if r["dtype"] == dt]
        bwd_rows = [r for r in k["gn_bwd"] if r["dtype"] == dt]
        gn = next(r for r in fwd_rows if r["shape"] == (2, 4096, 640))
        gb = next(r for r in bwd_rows if r["shape"][1] == 4096)
        for kind, row, rows, err in (
                ("gn_silu_fwd", gn, fwd_rows,
                 max(max(r["err"], r["stats_err"]) for r in fwd_rows)),
                ("gn_silu_bwd", gb, bwd_rows,
                 max(max(r["err"].values()) for r in bwd_rows))):
            measured[kind + sfx] = (
                err, row["ms"], row["plain_ms"],
                f"{list(row['shape'])} {str(dt)[6:]}",
                gn_bound(kind, row["shape"], dt), no_library)
            device[kind + sfx] = row["dev_ms"]
            extra[kind + sfx] = {
                "two_library_calls": {"ms": row["library_ms"],
                                      "device_ms": row["library_dev"]},
                "sites": _gn_sites(kind, rows)}
        extra["gn_silu_bwd" + sfx]["max_rel_err"] = max(
            max(r["rel"].values()) for r in bwd_rows)
        fwd_rows, bwd_rows = k["flash" + sfx], k["flash_bwd" + sfx]
        fl = next(r for r in fwd_rows if r["shape"] == FLASH_SITES[0])
        bwd = next(r for r in bwd_rows
                   if r["shape"] == (4, 4096, 4096, 10, 64))
        bwd_lib = (bwd["library_ms"], f"SDPA backward ({bwd['library']}) for "
                   "dq + dk/dv + Delta together")
        measured["flash_fwd" + sfx] = (
            max(r["err"] for r in fwd_rows), fl["ms"], fl["plain_ms"],
            _site(fl["shape"]), (fl["bound_ms"], fl["bound_by"]),
            (fl["library_ms"], f"SDPA ({fl['library']})"))
        measured["flash_bwd_dq" + sfx] = (
            max(r["err"]["dq"] for r in bwd_rows), bwd["dq_ms"],
            bwd["plain_dq_ms"], _site(bwd["shape"]), bwd["dq_bound"],
            bwd_lib)
        measured["flash_bwd_dkv" + sfx] = (
            max(max(r["err"]["dk"], r["err"]["dv"]) for r in bwd_rows),
            bwd["dkv_ms"], bwd["plain_dkv_ms"], _site(bwd["shape"]),
            bwd["dkv_bound"], bwd_lib)
        device.update({"flash_fwd" + sfx: fl["dev"],
                       "flash_bwd_dq" + sfx: bwd["dq_dev"],
                       "flash_bwd_dkv" + sfx: bwd["dkv_dev"]})
        library_device.update({"flash_fwd" + sfx: fl["library_dev"],
                               "flash_bwd_dq" + sfx: bwd["library_dev"],
                               "flash_bwd_dkv" + sfx: bwd["library_dev"]})
        # every site measured, for the forward at the serving step's sites
        # (fp32: and phase 9's; bf16: and the refiner's)
        sites = {torch.float32: F32_FWD_SITES,
                 torch.float16: FLASH_SITES}.get(
                     dt, FLASH_SITES + REFINER_FLASH_SITES)
        extra["flash_fwd" + sfx] = {"sites": [
            {"at": _site(r["shape"]), "ms": r["ms"], "device_ms": r["dev"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "library_device_ms": r["library_dev"]}
            for r in fwd_rows if r["shape"] in sites]}
        if dt != torch.bfloat16:
            for name in ("dq", "dkv"):
                extra[f"flash_bwd_{name}{sfx}"] = {"sites": [
                    {"at": _site(r["shape"]), "ms": r[f"{name}_ms"],
                     "device_ms": r[f"{name}_dev"],
                     "plain_ms": r[f"plain_{name}_ms"],
                     "bound_ms": r[f"{name}_bound"][0],
                     "bound_by": r[f"{name}_bound"][1],
                     "library_ms": r["library_ms"],
                     "library_device_ms": r["library_dev"]}
                    for r in bwd_rows]}
    adamw, adamw_n, probe_n = k["adamw"][1], 10240 * 1280, 4096 * 4096
    measured["fused_adamw"] = (
        max(r["err"] for r in k["adamw"]), adamw["ms"], adamw["plain_ms"],
        "[10240, 1280] bf16, fp32 g",
        bound(OPS_PER_ELEMENT["fused_adamw"] * adamw_n, (16 + 4) * adamw_n,
              PEAK_FP32), (None, None))
    measured["probe"] = (
        k["probe"]["max_abs_err"], k["probe"]["ms"], k["probe"]["plain_ms"],
        "[4096, 4096] fp32",
        bound(OPS_PER_ELEMENT["probe"] * probe_n, 8 * probe_n, PEAK_FP32),
        (k["probe"]["library_ms"], "torch.add(1, x, alpha=2)"))
    device.update({"fused_adamw": adamw["dev"], "probe": k["probe"]["dev"]})
    library_device["probe"] = k["probe"]["library_dev"]
    return {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": tpu,
         "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name], "max_abs_err": err, "ms": ms,
         "device_ms": device.get(name), "plain_ms": plain_ms,
         "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib[0],
         "library_device_ms": library_device.get(name), "library": lib[1],
         "at": at, **extra.get(name, {})}
        for name, (route, source, tpu) in KERNELS.items()
        for err, ms, plain_ms, at, bnd, lib in (measured[name],)]}


def main() -> None:
    phase_environment()
    phase_build()
    kernels = phase_kernels()
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    cfg = Config()
    t0 = time.perf_counter()
    model = SDXLModel.create(
        tiny=False, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED),
        unet_config=UNetConfig.sdxl(remat=cfg.tpu.remat,
                                    remat_policy=cfg.tpu.remat_policy))
    torch.cuda.synchronize()
    log(f"SDXLModel.create full width on cuda: "
        f"{time.perf_counter() - t0:.2f} s")
    phase_unet(model)
    serving = phase_slice(model)
    rest = phase_rest_of_serving(model)
    profile_unet_step(model)
    train = phase_train(model, cfg)
    phase_train_parity(model, cfg)
    del model
    _free()
    fp16 = phase_fp16()
    fp32 = phase_fp32_training()
    # each main path's launches, counted from 0 just before it ran
    paths = {"serving (phase 5)": serving["launches"],
             **{f"rest of serving (phase 10): {k}": v
                for k, v in rest.items()},
             "training (phase 6)": train["launches"],
             "fp16 (phase 8)": fp16["launches"],
             "fp32 training (phase 9)": fp32["train"]["launches"]}
    log(json.dumps(kernel_report(kernels, paths)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
