"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing what it found:

1. environment: the card's name and power limit, torch/CUDA/Triton/nvcc;
   fails at once when no CUDA device is present;
2. build: compiles the CUDA kernel library and the Triton kernels;
3. every kernel against its plain PyTorch version at the slice's shapes,
   with max errors and median CUDA-event times of both;
4. the full-width SDXL-base UNet (bf16, weights from a seed) at 1024^2,
   batch 2, through the kernels and through the plain versions;
5. the slice: ``SDXLModel.create`` at full width, ``SDXLPipeline.from_model``
   and one text-to-image call at 1024x1024, with per-phase times.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero without that line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

SEED = 0
STEPS = 8  # denoising steps of the measured text-to-image call

GN_SHAPES = (  # (shape, dtype, eps): UNet resnets bf16, VAE decoder fp32
    ((2, 16384, 320), torch.bfloat16, 1e-5),
    ((2, 4096, 640), torch.bfloat16, 1e-5),
    ((2, 1024, 2560), torch.bfloat16, 1e-5),
    ((1, 65536, 512), torch.float32, 1e-6),
    ((1, 1048576, 128), torch.float32, 1e-6),
)
FLASH_SHAPES = (  # (B, S, T, heads, D)
    (2, 4096, 4096, 10, 64),
    (2, 1024, 1024, 20, 64),
    (2, 4096, 77, 10, 64),
    (2, 9216, 9216, 10, 64),
    (2, 256, 256, 4, 16),
    (2, 64, 77, 8, 16),
    (2, 1024, 77, 4, 32),
    (2, 1024, 77, 4, 128),
)
GN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_OUT_TOL, FLASH_LSE_TOL = 2e-2, 1e-3
UNET_REL_L2_TOL = 3e-2
SLICE_REL_L2_TOL = 1e-1  # 8 CFG-5 steps compound the UNet's bf16 spread


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


def device_ms(fn, iters: int = 10):
    """Device time per call: the kernels' own time summed by
    ``torch.profiler`` (None when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


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
        groupnorm_silu_cuda)
    t0 = time.perf_counter()
    _build.load("flash_fwd")
    t1 = time.perf_counter()
    x = torch.randn(1, 64, 64, device="cuda")
    groupnorm_silu_cuda(x, torch.ones(64, device="cuda"),
                        torch.zeros(64, device="cuda"), 32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"build: nvcc flash_fwd {t1 - t0:.2f} s, "
        f"first Triton GN launch {t2 - t1:.2f} s")


def _gn_case(shape, dtype, eps, gen):
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    b, s, c = shape
    x = (torch.randn(shape, generator=gen, device="cuda") * 1.5 + 1.0
         ).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    # stats kernel against plain per-group statistics
    var, mean = torch.var_mean(x.reshape(b, s, 32, c // 32).float(),
                               dim=(1, 3), correction=0)
    stats = G.gn_silu_stats_cuda(x, 32)
    k_mean, k_rstd = G.combine_chunk_stats(*stats, eps)
    rstd = torch.rsqrt(var + eps)
    stats_err = max((k_mean - mean).abs().max().item(),
                    (k_rstd - rstd).abs().max().item())
    # the whole op against the fp32-interior plain version on the same
    # values (for bf16: the rounding of the output is the error)
    out = G.groupnorm_silu_cuda(x, scale, bias, 32, eps)
    ref = G.groupnorm_silu_reference(x.float(), scale, bias, 32, eps)
    err = (out.float() - ref).abs().max().item()

    def plain_stats():
        return torch.var_mean(x.reshape(b, s, 32, c // 32).float(),
                              dim=(1, 3), correction=0)

    def plain_apply():
        y = ((x.reshape(b, s, 32, c // 32).float() - mean[:, None, :, None])
             * rstd[:, None, :, None]).reshape(b, s, c) * scale + bias
        return (y * torch.sigmoid(y)).to(dtype)

    res = dict(
        err=err, stats_err=stats_err,
        stats_ms=time_ms(lambda: G.gn_silu_stats_cuda(x, 32)),
        apply_ms=time_ms(lambda: G.gn_silu_apply_cuda(
            x, *stats, scale, bias, 32, eps)),
        plain_stats_ms=time_ms(plain_stats),
        plain_apply_ms=time_ms(plain_apply),
        ms=time_ms(lambda: G.groupnorm_silu_cuda(x, scale, bias, 32, eps)),
        plain_ms=time_ms(lambda: G.groupnorm_silu_reference(
            x, scale, bias, 32, eps)),
        dev_ms=device_ms(lambda: G.groupnorm_silu_cuda(x, scale, bias, 32,
                                                       eps)),
        plain_dev_ms=device_ms(lambda: G.groupnorm_silu_reference(
            x, scale, bias, 32, eps)))
    log(f"gn_silu {list(shape)} {str(dtype)[6:]} eps={eps:g}: "
        f"max_abs_err {err:.3e} (tol {GN_TOL[dtype]:g}), stats (mean, "
        f"rstd) max_abs_err {stats_err:.3e}; per call kernel {res['ms']:.4f} ms (stats "
        f"{res['stats_ms']:.4f}, apply {res['apply_ms']:.4f}) vs plain "
        f"{res['plain_ms']:.4f} ms; device time kernel "
        f"{fmt_ms(res['dev_ms'])} vs plain {fmt_ms(res['plain_dev_ms'])}")
    check(err <= GN_TOL[dtype], f"gn_silu {shape} {dtype}: {err}")
    check(stats_err <= 1e-4, f"gn_silu stats {shape} {dtype}: {stats_err}")
    return res


def _flash_case(b, s, t, h, d, gen):
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for n in (s, t, t))
    out, lse = F.flash_attention_fwd_cuda(q, k, v)
    ref, ref_lse = F.flash_attention_fwd_reference(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ms = time_ms(lambda: F.flash_attention_fwd_cuda(q, k, v))
    plain_ms = time_ms(lambda: F.flash_attention_fwd_reference(q, k, v),
                       warmup=1, iters=2, repeats=3)
    dev = device_ms(lambda: F.flash_attention_fwd_cuda(q, k, v))
    plain_dev = device_ms(lambda: F.flash_attention_fwd_reference(q, k, v),
                          iters=2)
    tflops = 4 * b * h * s * t * d / (ms * 1e-3) / 1e12
    log(f"flash_fwd B={b} S={s} T={t} H={h} D={d}: out max_abs_err "
        f"{err:.3e} (tol {FLASH_OUT_TOL:g}), lse {lse_err:.3e} "
        f"(tol {FLASH_LSE_TOL:g}); kernel {ms:.4f} ms ({tflops:.1f} "
        f"TFLOP/s; device {fmt_ms(dev)}) vs plain {plain_ms:.4f} ms (device "
        f"{fmt_ms(plain_dev)})")
    check(err <= FLASH_OUT_TOL, f"flash out {(b, s, t, h, d)}: {err}")
    check(lse_err <= FLASH_LSE_TOL, f"flash lse {(b, s, t, h, d)}: {lse_err}")
    return dict(err=max(err, lse_err), ms=ms, plain_ms=plain_ms)


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gn = [_gn_case(shape, dt, eps, gen) for shape, dt, eps in GN_SHAPES]
    flash = [_flash_case(*shape, gen) for shape in FLASH_SHAPES]
    torch.cuda.empty_cache()
    return gn, flash


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
    for group, keys in (("flash_fwd (hand CUDA)", ("flash_fwd",)),
                        ("gn_silu (hand Triton)", ("stats_kernel",
                                                   "apply_kernel")),
                        ("convolution", ("conv", "fprop", "implicit",
                                         "nhwc", "dgrad")),
                        ("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
                        ("norm/softmax", ("norm", "softmax", "welford",
                                          "reduce")),
                        ("elementwise/copy", ("elementwise", "copy",
                                              "vectorized", "cat",
                                              "upsample", "index"))):
        if any(k in n for k in keys):
            return group
    return "other"


def profile_unet_step(model) -> None:
    """Where one denoising step's time goes: device time of one CFG
    forward (b2, 1024^2) by kernel group, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    ucfg = model.unet_config
    args = (torch.zeros(2, 4, 128, 128, device="cuda"),
            torch.tensor([500, 500], device="cuda"),
            torch.zeros(2, 77, ucfg.cross_attention_dim, device="cuda"),
            torch.zeros(2, ucfg.pooled_embed_dim, device="cuda"),
            torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2,
                         device="cuda"))
    with torch.inference_mode():
        model.unet_apply(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.unet_apply(*args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    launches = 0
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
        launches += e.count
    busy = sum(groups.values())
    log(f"unet step profile (b2 1024^2): wall {wall_ms:.2f} ms, device "
        f"busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{launches} kernel launches")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {ms:.2f} ms ({ms / busy:.3f})")


def _timed(fn, record):
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t0) * 1e3, a))
        return result
    return wrapper


def _kernel_wrappers():
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    return {"gn_silu_stats": G.gn_silu_stats_cuda,
            "gn_silu_apply": G.gn_silu_apply_cuda,
            "flash_fwd": F.flash_attention_fwd_cuda}


def phase_slice(model, size: int = 1024) -> dict:
    """Text-to-image at size x size through the port's pipeline."""
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    pipe = SDXLPipeline.from_model(model)
    pipe(["warm up"], height=size, width=size, num_inference_steps=2)
    rec = {"clip": [], "unet": [], "vae": []}
    with ExitStack() as stack:
        for name, attr in (("clip", "encode_prompt"), ("unet", "unet_apply"),
                           ("vae", "decode_latents")):
            stack.enter_context(mock.patch.object(
                model, attr, _timed(getattr(model, attr), rec[name])))
        wrappers = _kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = pipe(["a photograph of an astronaut riding a horse"],
                      height=size, width=size, num_inference_steps=STEPS,
                      guidance_scale=5.0, seed=SEED)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    latents = rec["vae"][0][1][0]
    img = images[0]
    step_ms = [t for t, _ in rec["unet"]]
    log(f"slice {size}x{size} euler {STEPS} steps guidance 5.0: image "
        f"{img.shape} {img.dtype}, latents {list(latents.shape)} finite "
        f"{bool(torch.isfinite(latents).all())}")
    log(f"slice times: clip encode {rec['clip'][0][0]:.2f} ms, unet "
        f"{statistics.mean(step_ms):.2f} ms/step over {len(step_ms)} "
        f"calls, vae decode {rec['vae'][0][0]:.2f} ms, total "
        f"{total_s:.3f} s, peak memory {peak_gb:.2f} GiB")
    log(f"slice kernel launches: {launches}")
    with _plain_ops():
        plain = pipe(["a photograph of an astronaut riding a horse"],
                     height=size, width=size, num_inference_steps=STEPS,
                     guidance_scale=5.0, seed=SEED, return_latents=True)
    rel = ((latents - plain).norm() / plain.norm()).item()
    log(f"slice latents, kernel path vs plain path (same seed): rel L2 "
        f"{rel:.3e} (tol {SLICE_REL_L2_TOL:g})")
    check(rel <= SLICE_REL_L2_TOL, f"slice latents rel L2 {rel}")
    check(img.shape == (size, size, 3) and img.dtype == np.uint8,
          f"image {img.shape} {img.dtype}")
    check(bool(torch.isfinite(latents).all()), "latents not finite")
    check(len(step_ms) == STEPS, f"{len(step_ms)} UNet calls")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    return launches


def kernel_report(gn, flash, launches) -> dict:
    gn_at, fl_at = 1, 0  # [2, 4096, 640] bf16; S=T=4096, 10 heads
    src = "sdxl_training_improvements_tpu_torch/"
    tpu = "sdxl_training_improvements_tpu/ops/"
    return {"kernels": [
        {"name": "gn_silu_stats", "route": "triton",
         "source": src + "ops/groupnorm.py",
         "replaces": tpu + "groupnorm.py:148", "launches":
             launches["gn_silu_stats"],
         "max_abs_err": max(r["stats_err"] for r in gn),
         "ms": gn[gn_at]["stats_ms"], "plain_ms": gn[gn_at]["plain_stats_ms"],
         "at": "[2, 4096, 640] bf16"},
        {"name": "gn_silu_apply", "route": "triton",
         "source": src + "ops/groupnorm.py",
         "replaces": tpu + "groupnorm.py:161", "launches":
             launches["gn_silu_apply"],
         "max_abs_err": max(r["err"] for r in gn),
         "ms": gn[gn_at]["apply_ms"], "plain_ms": gn[gn_at]["plain_apply_ms"],
         "at": "[2, 4096, 640] bf16"},
        {"name": "flash_fwd", "route": "cuda",
         "source": src + "csrc/flash_fwd.cu",
         "replaces": tpu + "flash_attention.py:49", "launches":
             launches["flash_fwd"],
         "max_abs_err": max(r["err"] for r in flash),
         "ms": flash[fl_at]["ms"], "plain_ms": flash[fl_at]["plain_ms"],
         "at": "B=2 S=T=4096 H=10 D=64"},
    ]}


def main() -> None:
    phase_environment()
    phase_build()
    gn, flash = phase_kernels()
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    t0 = time.perf_counter()
    model = SDXLModel.create(
        tiny=False, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"SDXLModel.create full width on cuda: "
        f"{time.perf_counter() - t0:.2f} s")
    phase_unet(model)
    launches = phase_slice(model)
    profile_unet_step(model)
    log(json.dumps(kernel_report(gn, flash, launches)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
