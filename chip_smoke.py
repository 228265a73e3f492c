"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing what it found:

1. environment: the card's name and power limit, torch/CUDA/Triton/nvcc;
   fails at once when no CUDA device is present;
2. build: compiles the three CUDA sources (one ``nvcc`` each, all started
   together) and the Triton kernels;
3. every kernel against its plain PyTorch version at the main paths'
   shapes, with max errors, median CUDA-event times and device times of
   both, and the rate: GN+SiLU, the flash forward, the flash backward
   (dq and dk/dv), the fused bf16-SR AdamW (``torch.equal`` to plain) and
   the startup probe; beside each, its bound (``bound_ms``: the larger of
   its flops over the card's peak and its bytes over 3.35 TB/s) and, as a
   yardstick the port never calls, one PyTorch call computing the same
   function where there is one (``library_ms``): SDPA's forward and
   backward under its fastest backend for the flash kernels, ``torch.add``
   for the probe;
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
   of all gradients.

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
DEVICE = "cuda"
SIZE = 1024  # image side of the training phases; latents are SIZE // 8

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
    (2, 1024, 77, 20, 64),
)
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
GN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_OUT_TOL, FLASH_LSE_TOL = 2e-2, 1e-3
# max abs error over the plain gradient's max magnitude: the kernels round
# P and dS to bf16 for their products, the plain backward keeps fp32
FLASH_BWD_TOL = 2e-2
UNET_REL_L2_TOL = 3e-2
SLICE_REL_L2_TOL = 1e-1  # 8 CFG-5 steps compound the UNet's bf16 spread
TRAIN_STEPS = 3
# b1 loss and all gradients, kernels against plain: measured 9.4e-4 and
# 4.0e-3 on an H100 (the kernels' bf16 rounding of P and dS, the GN
# kernel's fp32 interior against the plain bf16 one)
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_L2_TOL = 2e-2
PROMPTS = ("a photograph of an astronaut riding a horse",
           "a watercolor painting of a lighthouse at dawn",
           "a close-up of a red fox in the snow",
           "an isometric illustration of a tiny city")
# the wrappers of the main paths' kernels: route, source, TPU kernel
SRC = "sdxl_training_improvements_tpu_torch/"
TPU = "sdxl_training_improvements_tpu/ops/"
KERNELS = {
    "gn_silu_stats": ("triton", SRC + "ops/groupnorm.py",
                      TPU + "groupnorm.py:148"),
    "gn_silu_apply": ("triton", SRC + "ops/groupnorm.py",
                      TPU + "groupnorm.py:161"),
    "flash_fwd": ("cuda", SRC + "csrc/flash_fwd.cu",
                  TPU + "flash_attention.py:49"),
    "flash_bwd_dq": ("cuda", SRC + "csrc/flash_bwd.cu",
                     TPU + "flash_attention.py:115"),
    "flash_bwd_dkv": ("cuda", SRC + "csrc/flash_bwd.cu",
                      TPU + "flash_attention.py:145"),
    "fused_adamw": ("cuda", SRC + "csrc/fused_adamw.cu",
                    TPU + "fused_adamw.py:53"),
    "probe": ("triton", SRC + "ops/probe.py", TPU + "probe.py:106"),
}
SERVING_KERNELS = ("gn_silu_stats", "gn_silu_apply", "flash_fwd")
# the card's peaks (H100 SXM data sheet, dense): bf16 tensor cores, fp32
# outside them, device memory
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


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
    from sdxl_training_improvements_tpu_torch.ops.probe import probe_cuda
    t0 = time.perf_counter()
    _build.build_all(_build.KERNELS)
    for name in _build.KERNELS:
        _build.load(name)
    t1 = time.perf_counter()
    x = torch.randn(1, 64, 64, device="cuda")
    groupnorm_silu_cuda(x, torch.ones(64, device="cuda"),
                        torch.zeros(64, device="cuda"), 32)
    probe_cuda(x)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"build: nvcc {', '.join(_build.KERNELS)} in parallel "
        f"{t1 - t0:.2f} s, first Triton GN + probe launches {t2 - t1:.2f} s")


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


def sdpa_ms(q, k, v, dout=None):
    """(ms, backend) of the fastest of SDPA's flash, cuDNN and efficient
    backends on [B, H, S, D] views made before the timer starts: the
    forward, or with ``dout`` the backward (``torch.autograd.grad`` of one
    output).  A yardstick only: the port never calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        with sdpa_kernel(backend):
            try:
                if dout is None:
                    times[backend.name] = time_ms(lambda: sdpa(qt, kt, vt))
                    continue
                leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
                out = sdpa(*leaves)
                dt = dout.transpose(1, 2)
                times[backend.name] = time_ms(lambda: torch.autograd.grad(
                    out, leaves, dt, retain_graph=True))
                del out, leaves
            except RuntimeError:  # this backend does not take the shape
                continue
    if not times:
        return None, None
    best = min(times, key=times.get)
    return times[best], best


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
    lib_ms, lib = sdpa_ms(q, k, v)
    bound_ms, bound_by = bound(4 * b * h * s * t * d,
                               2 * (2 * s + 2 * t) * b * h * d + 4 * b * h * s)
    log(f"flash_fwd B={b} S={s} T={t} H={h} D={d}: out max_abs_err "
        f"{err:.3e} (tol {FLASH_OUT_TOL:g}), lse {lse_err:.3e} "
        f"(tol {FLASH_LSE_TOL:g}); kernel {ms:.4f} ms ({tflops:.1f} "
        f"TFLOP/s; device {fmt_ms(dev)}) vs plain {plain_ms:.4f} ms (device "
        f"{fmt_ms(plain_dev)}); bound {bound_ms:.4f} ms ({bound_by}); SDPA "
        f"{fmt_ms(lib_ms)} ({lib})")
    check(err <= FLASH_OUT_TOL, f"flash out {(b, s, t, h, d)}: {err}")
    check(lse_err <= FLASH_LSE_TOL, f"flash lse {(b, s, t, h, d)}: {lse_err}")
    return dict(err=max(err, lse_err), ms=ms, plain_ms=plain_ms, dev=dev,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                library=lib)


def _flash_bwd_case(b, s, t, h, d, gen):
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    q, k, v, dout = (torch.randn((b, n, h, d), generator=gen, device="cuda"
                                 ).to(torch.bfloat16) for n in (s, t, t, s))
    out, lse = F.flash_attention_fwd_cuda(q, k, v)
    scale = d ** -0.5
    delta = F.flash_attention_bwd_delta(out, dout)
    args = (q, k, v, dout, lse, delta, scale)
    got = (F.flash_bwd_dq_cuda(*args), *F.flash_bwd_dkv_cuda(*args))
    ref = (F.flash_bwd_dq_reference(*args),
           *F.flash_bwd_dkv_reference(*args))
    err, rel = {}, {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err[name] = (a.float() - r.float()).abs().max().item()
        rel[name] = err[name] / r.float().abs().max().item()
    del got, ref
    res = dict(err=err, rel=rel)
    for name, kernel, plain in (
            ("dq", F.flash_bwd_dq_cuda, F.flash_bwd_dq_reference),
            ("dkv", F.flash_bwd_dkv_cuda, F.flash_bwd_dkv_reference)):
        res[f"{name}_ms"] = time_ms(lambda: kernel(*args))
        res[f"{name}_dev"] = device_ms(lambda: kernel(*args))
        res[f"plain_{name}_ms"] = time_ms(lambda: plain(*args), warmup=1,
                                          iters=2, repeats=3)
        res[f"plain_{name}_dev"] = device_ms(lambda: plain(*args), iters=2)
    res["delta_ms"] = time_ms(lambda: F.flash_attention_bwd_delta(out, dout))
    res["library_ms"], res["library"] = sdpa_ms(q, k, v, dout)
    work = b * h * s * t * d  # 6 flops per unit in dq, 8 in dk/dv
    # bytes: q, k, v, dO bf16 and lse, Delta fp32 read; dq or dk, dv written
    read = 2 * (2 * s + 2 * t) * b * h * d + 8 * b * h * s
    res["dq_bound"] = bound(6 * work, read + 2 * b * s * h * d)
    res["dkv_bound"] = bound(8 * work, read + 4 * b * t * h * d)
    torch.cuda.empty_cache()
    dq_tf = 6 * work / (res["dq_ms"] * 1e-3) / 1e12
    dkv_tf = 8 * work / (res["dkv_ms"] * 1e-3) / 1e12
    pair_tf = 14 * work / ((res["dq_ms"] + res["dkv_ms"]) * 1e-3) / 1e12
    log(f"flash_bwd B={b} S={s} T={t} H={h} D={d}: max_abs_err dq "
        f"{err['dq']:.3e} dk {err['dk']:.3e} dv {err['dv']:.3e}, over max "
        f"|plain| {max(rel.values()):.3e} (tol {FLASH_BWD_TOL:g}); dq kernel "
        f"{res['dq_ms']:.4f} ms ({dq_tf:.1f} TFLOP/s; device "
        f"{fmt_ms(res['dq_dev'])}) vs plain {res['plain_dq_ms']:.4f} ms "
        f"(device {fmt_ms(res['plain_dq_dev'])}); dkv kernel "
        f"{res['dkv_ms']:.4f} ms ({dkv_tf:.1f} TFLOP/s; device "
        f"{fmt_ms(res['dkv_dev'])}) vs plain {res['plain_dkv_ms']:.4f} ms "
        f"(device {fmt_ms(res['plain_dkv_dev'])}); pair {pair_tf:.1f} "
        f"TFLOP/s; bounds dq {res['dq_bound'][0]:.4f} dkv "
        f"{res['dkv_bound'][0]:.4f} ms; dq + dkv + Delta "
        f"{res['dq_ms'] + res['dkv_ms'] + res['delta_ms']:.4f} ms vs SDPA "
        f"backward {fmt_ms(res['library_ms'])} ({res['library']})")
    check(max(rel.values()) <= FLASH_BWD_TOL,
          f"flash bwd {(b, s, t, h, d)}: {rel}")
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
    log(f"probe {list(P.PROBE_SHAPE)} fp32 x*2+1: max_abs_err "
        f"{res['max_abs_err']:.3e} (tol 0); kernel {res['ms']:.4f} ms "
        f"({res['gbps']:.1f} GB/s; device {fmt_ms(res['dev'])}) vs plain "
        f"{res['plain_ms']:.4f} ms ({res['plain_gbps']:.1f} GB/s; device "
        f"{fmt_ms(res['plain_dev'])}); torch.add(1, x, alpha=2) "
        f"{res['library_ms']:.4f} ms")
    check(res["max_abs_err"] == 0.0, f"probe error {res['max_abs_err']}")
    return res


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = dict(
        gn=[_gn_case(shape, dt, eps, gen) for shape, dt, eps in GN_SHAPES],
        flash=[_flash_case(*shape, gen) for shape in FLASH_SHAPES],
        flash_bwd=[_flash_bwd_case(*shape, gen)
                   for shape in FLASH_BWD_SHAPES],
        adamw=[_adamw_case(*case, gen) for case in ADAMW_SHAPES],
        probe=_probe_case())
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
    for group, keys in (("flash_fwd (hand CUDA)", ("flash_fwd",)),
                        ("flash_bwd (hand CUDA)", ("flash_bwd",
                                                   "dkv_reduce")),
                        ("fused_adamw (hand CUDA)", ("fused_adamw",)),
                        ("gn_silu (hand Triton)", ("stats_kernel",
                                                   "apply_kernel")),
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
    _log_profile(prof, "unet step (b2 1024^2)", wall_ms)


def _timed(fn, record):
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t0) * 1e3, a))
        return result
    return wrapper


def _kernel_wrappers() -> dict:
    """Every kernel wrapper of the main paths, by the name it is reported
    under; each counts its launches in ``.launches``."""
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    from sdxl_training_improvements_tpu_torch.ops import probe as P
    return {"gn_silu_stats": G.gn_silu_stats_cuda,
            "gn_silu_apply": G.gn_silu_apply_cuda,
            "flash_fwd": F.flash_attention_fwd_cuda,
            "flash_bwd_dq": F.flash_bwd_dq_cuda,
            "flash_bwd_dkv": F.flash_bwd_dkv_cuda,
            "fused_adamw": O.fused_adamw_cuda,
            "probe": P.probe_cuda}


def _zero_launches(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0


def _launches(wrappers: dict) -> dict:
    return {k: w.launches for k, w in wrappers.items()}


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
        wrappers = {k: w for k, w in _kernel_wrappers().items()
                    if k in SERVING_KERNELS}
        _zero_launches(wrappers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = pipe(["a photograph of an astronaut riding a horse"],
                      height=size, width=size, num_inference_steps=STEPS,
                      guidance_scale=5.0, seed=SEED)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = _launches(wrappers)
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


def _train_batch(model, n: int, gen) -> dict:
    """A training batch of ``n`` samples at 1024^2, keyed as the JAX
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
    return {"vae_latents": torch.randn(n, 4, SIZE // 8, SIZE // 8,
                                       generator=gen, device=DEVICE),
            "prompt_embeds": enc["prompt_embeds"],
            "pooled_prompt_embeds": enc["pooled_prompt_embeds"],
            "time_ids": torch.tensor([[SIZE, SIZE, 0, 0, SIZE, SIZE]] * n,
                                     dtype=torch.float32, device=DEVICE)}


WATCHED = ("mid_block.attentions.0.transformer_blocks.0.attn1.to_q.weight",
           "down_blocks.0.resnets.0.norm1.weight", "conv_norm_out.bias")


def phase_train(model, cfg) -> dict:
    """The training slice as the JAX entry drives it: ``make_optimizer`` ->
    ``make_train_step`` -> ``create_train_state`` -> ``TRAIN_STEPS`` steps
    at the default config; the last step runs under the profiler."""
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
    batch = _train_batch(model, n, gen)
    wrappers = _kernel_wrappers()
    _zero_launches(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    optimizer = make_optimizer(cfg)
    step = make_train_step(model.unet_apply, NoiseSchedule.from_config(cfg),
                           optimizer, cfg)
    state = create_train_state(model.trainable_params(), optimizer,
                               seed=t.seed)
    torch.cuda.synchronize()
    setup_launches = _launches(wrappers)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"train setup: {len(state.params)} leaves, {n_params} parameters, "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms (startup probe "
        f"{state.probe['ms']:.4f} ms, {state.probe['gbps']:.1f} GB/s); "
        f"launches {setup_launches}")
    watched = {k: state.params[k].detach().clone() for k in WATCHED}
    steps = []
    for i in range(TRAIN_STEPS):
        before = _launches(wrappers)
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
        row = dict(
            loss=metrics["loss"].item(), grad_norm=metrics["grad_norm"].item(),
            wall_ms=wall_ms,
            fwd_bwd_ms=events["start"].elapsed_time(events["backward"]),
            clip_ms=events["backward"].elapsed_time(events["clip"]),
            opt_ms=events["clip"].elapsed_time(events["update"]),
            launches={k: w.launches - before[k] for k, w in wrappers.items()})
        steps.append(row)
        log(f"train step {i + 1}{' (profiled)' if profiled else ''}: loss "
            f"{row['loss']:.6f}, grad norm {row['grad_norm']:.6f}; "
            f"{wall_ms:.2f} ms = forward+backward {row['fwd_bwd_ms']:.2f} + "
            f"clip {row['clip_ms']:.2f} + optimizer {row['opt_ms']:.2f} ms "
            f"(CUDA events); launches {row['launches']}")
        if profiled:
            row["idle"] = _log_profile(
                prof, f"train step {i + 1} (b{n} {SIZE}^2)", wall_ms)
        check(np.isfinite(row["loss"]), f"train step {i + 1} loss not finite")
        check(np.isfinite(row["grad_norm"]), f"step {i + 1} grad norm")
        for k in KERNELS:
            if k != "probe":
                check(row["launches"][k] > 0,
                      f"kernel {k} was not launched in train step {i + 1}")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    changed = {k: int((state.params[k].detach() != v).sum())
               for k, v in watched.items()}
    log(f"train: {TRAIN_STEPS} steps, batch {n} at {SIZE}^2, remat "
        f"{model.unet_config.remat} ({model.unet_config.remat_policy}); "
        f"peak memory {peak_gb:.2f} GiB; elements changed in watched "
        f"leaves {changed}")
    check(all(changed.values()), f"parameters did not change: {changed}")
    check(setup_launches["probe"] > 0, "the startup probe did not launch")
    launches = {k: setup_launches[k] + sum(r["launches"][k] for r in steps)
                for k in wrappers}
    log(f"train kernel launches (setup + {TRAIN_STEPS} steps): {launches}")
    del state, watched
    torch.cuda.empty_cache()
    return dict(steps=steps, peak_gb=peak_gb, launches=launches)


def phase_train_parity(model, cfg) -> dict:
    """One forward and backward at batch 1, 1024^2, with replayed noise
    and timestep, through the kernels and through the plain versions:
    the loss and the relative L2 of all gradients together."""
    from sdxl_training_improvements_tpu_torch.training.methods import (
        get_method)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    batch = _train_batch(model, 1, gen)
    batch["noise"] = torch.randn(1, 4, SIZE // 8, SIZE // 8, generator=gen,
                                 device=DEVICE)
    batch["timesteps"] = torch.tensor([500], device=DEVICE)
    loss_fn = get_method(cfg.training.method)
    schedule = NoiseSchedule.from_config(cfg)
    params = list(model.unet.parameters())

    def loss_and_grads():
        """(loss, gradients, ms of the second of two calls): the first
        call at a new batch size pays allocator growth and Triton's
        re-specialisation."""
        for _ in range(2):
            grads = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = loss_fn(model.unet_apply, batch, None, schedule,
                              cfg.model)
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
        return loss.item(), grads, (time.perf_counter() - t0) * 1e3

    loss, grads, ms = loss_and_grads()
    with _plain_ops():
        plain_loss, plain_grads, plain_ms = loss_and_grads()
    num = sum((a.float() - b.float()).square().sum()
              for a, b in zip(grads, plain_grads))
    den = sum(b.float().square().sum() for b in plain_grads)
    rel = (num / den).sqrt().item()
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    log(f"train parity (b1 {SIZE}^2, t=500): loss kernels {loss:.6f} vs plain "
        f"{plain_loss:.6f}, rel {loss_rel:.3e} (tol {TRAIN_LOSS_REL_TOL:g}); "
        f"all {len(grads)} gradients rel L2 {rel:.3e} (tol "
        f"{TRAIN_GRAD_REL_L2_TOL:g}), finite {finite}; warm forward+backward "
        f"{ms:.2f} ms vs plain {plain_ms:.2f} ms")
    check(finite, "train parity: a gradient is not finite")
    check(loss_rel <= TRAIN_LOSS_REL_TOL, f"train parity loss {loss_rel}")
    check(rel <= TRAIN_GRAD_REL_L2_TOL, f"train parity gradients {rel}")
    del grads, plain_grads
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_l2=rel, ms=ms, plain_ms=plain_ms)


# operations per element of the elementwise kernels, on the fp32 units
# (not the tensor cores): GN statistics (sum, square, add), GN apply
# (normalise, affine, SiLU), AdamW (moments, bias corrections, sqrt,
# divide, decay, stochastic rounding), the probe (x * 2 + 1)
OPS_PER_ELEMENT = {"gn_silu_stats": 3, "gn_silu_apply": 10,
                   "fused_adamw": 40, "probe": 2}


def kernel_report(k: dict, launches: dict) -> dict:
    """One entry per kernel wrapper: errors over all of phase 3's shapes;
    times, bound and library time at the shape named in ``at``; launches on
    the training path."""
    gn, fl, bwd, adamw = k["gn"][1], k["flash"][0], k["flash_bwd"][0], \
        k["adamw"][1]
    gn_n, adamw_n, probe_n = 2 * 4096 * 640, 10240 * 1280, 4096 * 4096
    ew = {name: bound(OPS_PER_ELEMENT[name] * n, nbytes, PEAK_FP32)
          for name, n, nbytes in (
              ("gn_silu_stats", gn_n, 2 * gn_n),
              ("gn_silu_apply", gn_n, 2 * 2 * gn_n),
              ("fused_adamw", adamw_n, (16 + 4) * adamw_n),
              ("probe", probe_n, 8 * probe_n))}
    bwd_lib = (bwd["library_ms"], f"SDPA backward ({bwd['library']}) for "
               "dq + dk/dv + Delta together")
    # (max abs err, ms, plain ms, at, (bound ms, by), (library ms, what))
    measured = {
        "gn_silu_stats": (max(r["stats_err"] for r in k["gn"]),
                          gn["stats_ms"], gn["plain_stats_ms"],
                          "[2, 4096, 640] bf16", ew["gn_silu_stats"],
                          (None, None)),
        "gn_silu_apply": (max(r["err"] for r in k["gn"]), gn["apply_ms"],
                          gn["plain_apply_ms"], "[2, 4096, 640] bf16",
                          ew["gn_silu_apply"], (None, None)),
        "flash_fwd": (max(r["err"] for r in k["flash"]), fl["ms"],
                      fl["plain_ms"], "B=2 S=T=4096 H=10 D=64",
                      (fl["bound_ms"], fl["bound_by"]),
                      (fl["library_ms"], f"SDPA ({fl['library']})")),
        "flash_bwd_dq": (max(r["err"]["dq"] for r in k["flash_bwd"]),
                         bwd["dq_ms"], bwd["plain_dq_ms"],
                         "B=4 S=T=4096 H=10 D=64", bwd["dq_bound"], bwd_lib),
        "flash_bwd_dkv": (max(max(r["err"]["dk"], r["err"]["dv"])
                              for r in k["flash_bwd"]),
                          bwd["dkv_ms"], bwd["plain_dkv_ms"],
                          "B=4 S=T=4096 H=10 D=64", bwd["dkv_bound"],
                          bwd_lib),
        "fused_adamw": (max(r["err"] for r in k["adamw"]), adamw["ms"],
                        adamw["plain_ms"], "[10240, 1280] bf16, fp32 g",
                        ew["fused_adamw"], (None, None)),
        "probe": (k["probe"]["max_abs_err"], k["probe"]["ms"],
                  k["probe"]["plain_ms"], "[4096, 4096] fp32", ew["probe"],
                  (k["probe"]["library_ms"], "torch.add(1, x, alpha=2)")),
    }
    # the kernels' own time per call from torch.profiler, where measured
    device = {"flash_fwd": fl["dev"], "flash_bwd_dq": bwd["dq_dev"],
              "flash_bwd_dkv": bwd["dkv_dev"], "fused_adamw": adamw["dev"],
              "probe": k["probe"]["dev"]}
    return {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": tpu,
         "launches": launches[name], "max_abs_err": err, "ms": ms,
         "device_ms": device.get(name), "plain_ms": plain_ms,
         "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib[0],
         "library": lib[1], "at": at}
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
    phase_slice(model)
    profile_unet_step(model)
    train = phase_train(model, cfg)
    phase_train_parity(model, cfg)
    log(json.dumps(kernel_report(kernels, train["launches"])))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
