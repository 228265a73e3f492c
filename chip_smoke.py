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
   (``torch.equal`` to plain; also the second half of a [10240, 1280]
   leaf at element base n/2, a ZeRO chunk, under hash and rbg noise,
   ``torch.equal`` to the whole leaf's second half, and timed; and rank
   1's megatron slices of that leaf laid out as JAX's [1280, 10240]: the
   columns split 2 and 4 ways and the GEGLU's value and gate halves split
   2 ways, each ``torch.equal`` to the same elements of the whole leaf's
   update and to its plain version, hash (the strided instantiation)
   and rbg, timed with its bound) and the startup
   probe; the flash kernels of
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
   split, peak memory, one profiled step and the kernels' launches; its
   batch, losses, grad norms and parameter digests are kept for phase
   15;
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
   safetensors writer into a temporary directory kept for phase 13,
   ``SDXLPipeline.from_pretrained`` back: every tensor ``torch.equal``,
   the key audit empty), ``generate.main`` on that directory at 1024^2
   (DPM++ 2M, DeepCache 2; its PNG read back, then ``--init`` with it at
   strength 0.35), and each new mode through the kernels against the plain
   versions (latents within ``SLICE_REL_L2_TOL``): DPM++ 2M, Euler with
   DeepCache 2 (its first call bit-equal to the uncached one), flow
   matching, img2img, inpainting on a seeded full-width 9-channel UNet and
   the base -> refiner handoff on a seeded full-width refiner, each extra
   model freed before the next.  Phase 3 also holds the GN+SiLU forward at
   the refiner's widths (bf16) and the fp32 VAE encoder's, and the bf16
   flash forward at the refiner's attention sites;
11. the training entry point, after phase 9 with the earlier models freed,
   and after the decode check: every committed JPEG and WebP fixture
   (``tests/fixtures/images``) decoded by the port's reader on the card's
   host, each result's sha256 (RGB and L) against Pillow's in the
   fixtures' manifest, and the host ms per megapixel of baseline 4:2:0
   and progressive JPEG at 1024^2 and of the two WebP entry files.
   ``main.main`` on ``configs/novelai_v3_1024.yaml`` as the
   port's YAML reader loads it (full SDXL-base width, seeded weights, the
   cuts logged) over 8 images in a temporary directory, 4 at 1024x1024
   and 4 at 1216x832: four committed JPEGs (baseline 4:2:0 with restart
   markers, progressive 4:2:0, baseline 4:4:4, grayscale), two committed
   WebPs (lossy with alpha at 1024x1024, lossless at 1216x832) and two
   PNGs written here (a palette PNG, an Adam7 PNG);
   run A (2 epochs, 4 steps: the cache's latent shapes, each
   step's loss read after the run, step 3 timed as one window between
   two synchronizes, step 4 profiled for device time and idle share,
   peak memory, launches); then, on run A's model, the precompute's rate
   over 32 PNGs through the trainer's own precompute, one image of each
   size through the fp32 VAE kernels against plain, a b1 forward and
   backward on the 1216x832 bucket's cache entry through the kernels
   against plain, and the convolutions' device time with cuDNN's
   deterministic algorithms and its defaults; run B (1 epoch and the final
   checkpoint, then ``--resume`` to 2 epochs: the checkpoint's GiB, save
   and restore times), whose parameters, optimizer state, step and
   generators must be ``torch.equal`` to run A's; the log's metric lines;
   the directory deleted.  Phase 3 also holds the bf16 GN+SiLU and flash
   kernels at the 1216x832 bucket's sites (S = 3952 and 988);
12. the remaining training features, after phase 11 with its models
   freed, each at full SDXL-base width on phase 11's recipe and cuts:
   (12a) ``main.main`` with LoRA (rank 4, the default targets) and EMA
   0.9999 over phase 11's four 1024x1024 images, 2 epochs (one step
   each) with step 2 profiled (device
   time, idle share, the update's ms by CUDA events, peak memory,
   launches); on its model, with seeded trees, the merge path against
   the branch path (dropout 0), the LoRA gradients through the kernels
   against the kernels' plain versions at a trained adapter's scale, and
   with adapters outweighing the base every bf16 path's and the fp32
   kernels' gradients against an fp32 plain reference; then 1 epoch with the
   final checkpoint, whose adapter (``import_lora``) and merged UNet are
   read back ``torch.equal``, and ``--resume`` to 2 epochs, ``torch.equal``
   to the uninterrupted run; (12b-12e) on one seeded model, its UNet
   reset before each, ``make_optimizer`` -> ``make_train_step`` ->
   ``create_train_state`` at b4 1024^2: schedule-free (3 steps, warmup 2;
   ``eval_params`` is x), SOAP (the install, then Adam with a QR refresh;
   its memory reckoned from the UNet's shapes and cut by ``SOAP_CUTS``
   until it fits) and adamw_bf16 with int8 moments (3 steps; 4 state
   bytes a parameter; one [10240, 1280] leaf through dequantize -> the
   CUDA fused AdamW -> quantize ``torch.equal`` to the plain chain), and
   (12e) adamw_bf16 with an EMA shadow of the whole UNet (2 steps);
   each sub-path's loss, state and peak GiB, step profile and launches;
   and each new state's resume through ``main.main`` on the tiny model;
13. the serving entry points, right after phase 10 on its bf16 base and
   its checkpoint: (13a) ``aot.export_text2img`` at 1024^2, b1, Euler,
   8 steps, guidance 5, then ``AOTPipeline.load``, which captures the
   encode, the CFG UNet call and the fp32 VAE decode as CUDA graphs in one
   pool (capture s, graphs and their nodes, pool GiB logged); 4 images
   through the graphs and 2 through the eager kernel path (UNet wall ms a
   step, median and p90, s an image, one image's latents profiled for
   device busy ms and idle share), the graph latents against the eager
   kernel path at the same seeds (rel L2 within ``AOT_REL_L2_TOL``,
   ``torch.equal`` logged) and against the plain versions (within
   ``SLICE_REL_L2_TOL``), the decode graph within one uint8 step of the
   eager decode of the same latents, whose fp32 output is finite; (13b)
   the same for DPM++ 2M with DeepCache 2
   (the full call with ``return_deep`` and the shallow one, each a
   graph); (13c) ``serve.build_server`` on port 0 in a thread over 13a's
   artifact: /healthz, two concurrent requests whose PNGs, read back by
   ``png.read_png``, equal ``AOTPipeline``'s images, a 400 on a batch
   mismatch, 3 requests timed (the launches counted over the served
   requests alone, the reference images made after); (13d) ``generate.main`` with
   ``--export-aot`` and then ``--aot`` on phase 10's checkpoint, and the
   exit on a conflicting ``--steps``.  Each graph path's launches are its
   launches per capture times its replays (the wrappers count a capture
   once);
14. the single-card training settings, last, on a seeded full-width
   model of the default ``Config()`` (bf16, b4 1024^2, remat): (14a)
   every remat policy of ``models/unet.py``: one forward and backward at
   fixed noise and timesteps under cuDNN's deterministic algorithms,
   whose gradients must be ``torch.equal`` to "full"'s (or within phase
   7's bar, said so), the UNet kernels launched in it, its peak GiB and
   the GiB of the outputs it keeps, then one profiled train step for
   "full" on a warm train state (device ms, idle share, launches, peak
   GiB; its rollup and top kernels through ``tools/profile_step``'s
   summary); (14b) the bf16 AdamW under each
   layout (per-leaf hash and rbg, flat, hybrid, stacked): two steps, the
   optimizer's ms by CUDA events, kernel #7's launches a step by
   variant, state and peak GiB; then, the model freed, #7's rbg variant
   against its plain version on the [10240, 1280] leaf (timed, with its
   bound) and on the largest flat group, and the stacked layout's launch
   (one decay amount per row) on the stack of most rows within
   STACK_CHECK_MAX elements (the plain chain's fp64 temporaries), each
   ``torch.equal``; (14c) ``main.main`` on
   ``configs/v5e16_single_chip.yaml`` (int8 moments, shift_host,
   moments_host) with phase 11's cuts over phase 11's four 1024x1024
   images: 2 steps with
   the update's ms by CUDA events, the optimizer state on the card
   (none) and on the host (pinned), peak GiB, launches; the streamed
   update against the copies alone and the resident update (the share of
   the copy time hidden); then 1 epoch with the final checkpoint and
   ``--resume``, ``torch.equal`` to the uninterrupted run;
15. training over several cards, after phase 14: W ranks (the cards
   shown, 1, 2 or 4), each a process of this script (``--phase15-rank
   DIR``) joined through JAX's env triple on NCCL: (15a)
   ``parallel/dryrun.dryrun_multichip(W)`` at tiny shapes; (15b) the
   default ``Config()`` model on mesh [W,1,1] and on [1,W,1] with
   ``shard_params`` (each rank storing only its fsdp chunks of the large
   leaves, which every unit of the UNet gathers to run; one card: the
   two meshes are [1,1,1], run once), 3 steps each on
   phase 6's batch (one card: losses, grad norms and parameter digests
   equal to phase 6's; more: JAX's bars), with each rank's step device
   ms, NCCL kernels' device ms, parameter, gradient-accumulator,
   optimizer-state and peak GiB, the fsdp all-gathers and #7 launches a
   step beside the card's name and power limit; (15c) ``main.main`` on
   phase 11's recipe and cuts over its four 1024x1024 images with the
   partitioned cache, mesh [1,W,1],
   ``shard_params`` and W-row micro-batches: 2 epochs, then 1 with the
   final checkpoint and ``--resume``, ``torch.equal`` to the
   uninterrupted run on the card, each rank's cache under ``host-NNN``
   (one rank: the plain cache, as JAX's), with parameter,
   gradient-accumulator and peak GiB and the fsdp all-gathers a step;
16. the tensor axis, in phase 15's rank processes on 15b's model: mesh
   [1,1,W] over the W cards, phase 5's text-to-image call through
   ``SDXLPipeline(mesh=)`` and phase 6's 3 steps with the UNet's
   transformer blocks megatron-split (``shard_train_state(unet=)``); one
   card runs the tensor code path at T = 1 and must give phase 5's
   latents and phase 6's losses, grad norms and parameter digests bit for
   bit; more cards run NCCL at T = W within phase 15's bars; each rank's
   step device ms, NCCL device ms, peak GiB and #7 launches a step beside
   the card's name and power limit;
17. the tools (``sdxl_training_improvements_tpu_torch/tools``): the first
   30 steps of both 1000-step JAX loss curves (``tests/fixtures/parity``)
   through ``parity_check`` on the kernels at the 1% bar; 10 steps of
   each ``study_int8_moments`` arm (finite, #7 launched in the bf16 and
   int8 arms); ``verify_checkpoint`` on phase 10's checkpoint (passes)
   and on a copy of its VAE with a key removed (fails).  (``profile_step``
   ran here at b1 until the script outgrew its time limit; phase 14a's
   profiled step prints its summary.)

The line before the last is a JSON object with one entry per kernel and
dtype (``launches``: the sum over the main paths, ``launches_by_path``:
each path's count, read just after it ran with the counts set to 0 just
before); the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises and the script exits non-zero without that line.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from contextlib import ExitStack
from pathlib import Path
from typing import Optional
from unittest import mock

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.tools import card as _card
# the port's one grouping and summary of device events
# (tools/profile_step.py)
from sdxl_training_improvements_tpu_torch.tools.profile_step import (
    device_events as _device_events, kernel_group as _kernel_group,
    summarize as _summarize)

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
# phase 11's landscape bucket (1216x832: latents 104x152) at b1 in bf16:
# attention at 52x76 and 26x38 (S = 3952 and 988, neither a multiple of
# the kernels' tiles), and GroupNorm at the three levels (C/G = 10, 30,
# 20, 80)
ENTRY_FLASH_SITES = ((1, 3952, 3952, 10, 64), (1, 3952, 77, 10, 64),
                     (1, 988, 988, 20, 64), (1, 988, 77, 20, 64))
ENTRY_GN_SHAPES = ((1, 15808, 320), (1, 15808, 960), (1, 3952, 640),
                   (1, 988, 2560))
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
    # the same kernel reading drawn noise planes (its kPlanes template
    # instantiation), in place of JAX's XLA chain on rbg planes
    "fused_adamw_rbg": ("cuda", SRC + "csrc/fused_adamw.cu",
                        TPU + "fused_adamw.py:53"),
    # its hash variant over a megatron slice, whose elements map to their
    # places in the whole leaf (the kStrided template instantiation)
    "fused_adamw_strided": ("cuda", SRC + "csrc/fused_adamw.cu",
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


def time_ms(fn, warmup: int = 3, iters: int = 10, repeats: int = 3
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
        total_ms = sum(ms for _, ms in _device_events(prof))
        if total_ms > 0:
            return total_ms / iters
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_environment() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = _card(DEVICE)
    log(smi)
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
    return smi


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


def _adamw_base_case(gen) -> dict:
    """Kernel #7 on the second half of a [10240, 1280] leaf at element base
    n/2 (the chunk that rank 1 of an fsdp axis of 2 updates): under hash
    and rbg noise, ``torch.equal`` in every output to the second half of
    the whole leaf's plain update and to its own plain version at that
    base (rbg: the second half of the leaf's planes)."""
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O
    shape = (10240, 1280)

    def randn(scale):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    p, g, m = randn(0.05).bfloat16(), randn(1e-3), randn(1e-4).bfloat16()
    v = (1e-8 * randn(1.0).square()).bfloat16()
    shift = randn(1e-7).bfloat16()
    n = p.numel()
    half = n // 2
    planes = O.draw_planes(n, gen)

    def part(x):
        return x.reshape(-1)[half:]
    res = {}
    for noise in ("hash", "rbg"):
        kw = dict(lr_eff=1e-4 * (1 - 0.999 ** 3) ** 0.5, decay_amt=5.02e-3,
                  seed0=0x9E3779B9, seed1=0x7F4A7C15,
                  planes=planes if noise == "rbg" else None)
        whole = [part(x) for x in O.fused_adamw_reference(
            p, g, m, v, shift, **kw)]
        ckw = dict(kw, base=half, planes=(
            planes[:, half:].contiguous() if noise == "rbg" else None))
        plain = O.fused_adamw_reference(*map(part, (p, g, m, v, shift)),
                                        **ckw)
        got = O.fused_adamw_cuda(part(p), part(g), part(m).clone(),
                                 part(v).clone(), part(shift).clone(), **ckw)
        names = ("delta", "m", "v", "shift")
        equal = {k: torch.equal(a, w) and torch.equal(a, b)
                 for k, a, w, b in zip(names, got, whole, plain)}
        err = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(got, whole))
        # the chunk's launch times the instantiation with the base (hash:
        # its own, ``kBase``); bytes as _adamw_case's, rbg + 8 of planes
        chunk = [part(x).clone() for x in (m, v, shift)]
        args = (part(p), part(g), *chunk)
        moved = (16 + 4 + (8 if noise == "rbg" else 0)) * (n - half)
        res[noise] = dict(
            equal=all(equal.values()), err=err,
            ms=time_ms(lambda: O.fused_adamw_cuda(*args, **ckw)),
            device_ms=device_ms(lambda: O.fused_adamw_cuda(*args, **ckw)),
            bound_ms=bound(OPS_PER_ELEMENT["fused_adamw"] * (n - half),
                           moved, PEAK_FP32)[0])
        log(f"fused_adamw {noise} at base n/2 (the second half of "
            f"{list(shape)}): torch.equal to the whole leaf's update and to "
            f"plain {equal}, max_abs_err {err:.3e}; kernel "
            f"{res[noise]['ms']:.4f} ms (device "
            f"{fmt_ms(res[noise]['device_ms'])}; bound "
            f"{res[noise]['bound_ms']:.4f} ms)")
        check(res[noise]["equal"], f"fused_adamw {noise} at base n/2: "
              f"not equal {equal}")
        del whole, plain, got, chunk, args
    return res


# (kind, tensor size) of the megatron slices #7 is held on in phase 3:
# rank 1's slice of a [10240, 1280] GEGLU projection in the JAX layout
# ([in, out] in memory), whose column slices are strided
STRIDED_SLICES = (("column", 2), ("column", 4), ("geglu", 2))


def _adamw_strided_case(gen) -> dict:
    """Kernel #7 over megatron slices (``STRIDED_SLICES``) of a [10240,
    1280] leaf laid out as JAX's [1280, 10240]: the slice's elements are
    runs of 10240 / T (a GEGLU's: its value and gate halves, each 5120 /
    T) 10240 apart, and the hash variant maps each to its place in the
    whole leaf (the ``kStrided`` instantiation; rbg: the whole leaf's
    planes gathered through the map).  Every output ``torch.equal`` to
    the same elements of the whole leaf's update by the kernel and to the
    slice's own plain version; each slice timed, with its bound."""
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    shape = (10240, 1280)

    def randn(scale):  # [out, in] with the JAX layout's strides
        return scale * torch.randn(shape[::-1], generator=gen,
                                   device="cuda").t()

    p, g, m = randn(0.05).bfloat16(), randn(1e-3), randn(1e-4).bfloat16()
    v = (1e-8 * randn(1.0).square()).bfloat16()
    shift = randn(1e-7).bfloat16()
    planes = O.draw_planes(p.numel(), gen)
    like = torch.empty_strided(p.shape, p.stride(), device="meta")
    rows = []
    for noise in ("hash", "rbg"):
        kw = dict(lr_eff=1e-4 * (1 - 0.999 ** 3) ** 0.5, decay_amt=5.02e-3,
                  seed0=0x9E3779B9, seed1=0x7F4A7C15)
        whole = O.fused_adamw_cuda(
            p, g, m.clone(), v.clone(), shift.clone(), **kw,
            planes=planes if noise == "rbg" else None)
        for kind, t in STRIDED_SLICES:
            split = M.TPSplit(dim=0, jax_dim=1, size=t, rank=1,
                              glu=kind == "geglu", like=like)
            imap = split.index_map()
            local = [split.cut(x) for x in (p, g, m, v, shift)]
            n = local[0].numel()
            skw = dict(kw, imap=imap, planes=None if noise == "hash" else
                       planes[:, imap.indices(0, n, planes.device)
                              ].contiguous())
            plain = O.fused_adamw_reference(*local, **skw)
            got = O.fused_adamw_cuda(local[0], local[1],
                                     *(x.clone() for x in local[2:]), **skw)
            names = ("delta", "m", "v", "shift")
            equal = {k: torch.equal(a, split.cut(w)) and torch.equal(a, b)
                     for k, a, w, b in zip(names, got, whole, plain)}
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, plain))
            state = [x.clone() for x in local[2:]]
            moved = (16 + 4 + (8 if noise == "rbg" else 0)) * n
            bnd = bound(OPS_PER_ELEMENT["fused_adamw"] * n, moved,
                        PEAK_FP32)
            row = dict(
                kind=kind, tensor=t, rank=1, noise=noise, elements=n,
                index_map=str(imap), equal=all(equal.values()), err=err,
                ms=time_ms(lambda: O.fused_adamw_cuda(
                    local[0], local[1], *state, **skw)),
                device_ms=device_ms(lambda: O.fused_adamw_cuda(
                    local[0], local[1], *state, **skw)),
                plain_ms=None, bound_ms=bnd[0], bound_by=bnd[1])
            if not rows:  # the kernel line's case
                row["plain_ms"] = time_ms(lambda: O.fused_adamw_reference(
                    *local, **skw), warmup=1, iters=3, repeats=3)
            rows.append(row)
            log(f"fused_adamw {noise} over a megatron slice ({kind}, rank 1 "
                f"of {t}) of {list(shape)} in the JAX layout, {n} elements, "
                f"{imap}: torch.equal to the whole leaf's update and to "
                f"plain {equal}, max_abs_err {err:.3e}; kernel "
                f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}; "
                f"bound {bnd[0]:.4f} ms, {bnd[1]}); plain "
                f"{fmt_ms(row['plain_ms'])}")
            check(row["equal"], f"fused_adamw {noise} {kind} slice of {t}: "
                  f"not equal {equal}")
            del plain, got, state, local
        del whole
    return rows


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
            GN_SHAPES + REFINER_GN_SHAPES + ENCODER_GN_SHAPES
            + tuple((s, torch.bfloat16, 1e-5) for s in ENTRY_GN_SHAPES)],
        gn_bwd=[_gn_bwd_case(shape, dt, gen) for shape, dt in
                GN_BWD_SHAPES
                + tuple((s, torch.bfloat16) for s in ENTRY_GN_SHAPES)],
        flash=[_flash_case(*shape, gen) for shape in
               FLASH_SHAPES + REFINER_FLASH_SITES + ENTRY_FLASH_SITES],
        flash_bwd=[_flash_bwd_case(*shape, gen)
                   for shape in FLASH_BWD_SHAPES + ENTRY_FLASH_SITES],
        adamw=[_adamw_case(*case, gen) for case in ADAMW_SHAPES],
        adamw_base=_adamw_base_case(gen),
        adamw_strided=_adamw_strided_case(gen),
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


def _kernels_plain_versions():
    """The flash and GN+SiLU autograd Functions with each kernel replaced
    by its plain version (``*_reference``), as phase 3 holds them: the
    backward keeps the kernels' formulas (Delta = rowsum(dO * O) from the
    saved 16-bit output), where ``_plain_ops``'s attention lets autograd
    differentiate the softmax."""
    from sdxl_training_improvements_tpu_torch.ops import flash_attention
    from sdxl_training_improvements_tpu_torch.ops import groupnorm
    stack = ExitStack()
    for module, name, plain in (
            (flash_attention, "flash_attention_fwd_cuda",
             flash_attention.flash_attention_fwd_reference),
            (flash_attention, "flash_attention_bwd_cuda",
             flash_attention.flash_attention_bwd_reference),
            (groupnorm, "gn_silu_fwd_cuda", groupnorm.gn_silu_fwd_reference),
            (groupnorm, "gn_silu_bwd_cuda",
             groupnorm.groupnorm_silu_backward_reference)):
        stack.enter_context(mock.patch.object(module, name, plain))
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


def _log_profile(prof, what: str, wall_ms: float, top: int = 0) -> float:
    """Log device busy time by kernel group (``profile_step.summarize``)
    and the idle share of a profiled window of ``wall_ms``, and the
    ``top`` kernels by device time; returns the idle share."""
    s = _summarize(_device_events(prof), wall_ms, top=top)
    log(f"{what} profile: wall {wall_ms:.2f} ms, device busy "
        f"{s['busy_ms']:.2f} ms, idle share {s['idle_share']:.3f}, "
        f"{s['events']} kernel launches")
    for g, v in s["groups"].items():
        log(f"  {g}: {v['ms']:.2f} ms ({v['share']:.3f}), calls "
            f"{v['calls']}")
    for r in s["top"]:
        log(f"  top {r['ms']:9.3f} ms {r['share']:.3f} n={r['calls']:<5} "
            f"[{r['group']}] {r['name'][:100]}")
    return s["idle_share"]


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
    counters = {"fused_adamw": functools.partial(
                    O.fused_adamw_cuda.launches_by_noise.__getitem__, "hash"),
                "fused_adamw_rbg": functools.partial(
                    O.fused_adamw_cuda.launches_by_noise.__getitem__, "rbg"),
                "fused_adamw_strided": functools.partial(
                    O.fused_adamw_cuda.launches_by_noise.__getitem__,
                    "strided"),
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
    O.fused_adamw_cuda.launches_by_noise.clear()
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
    return dict(launches=launches, finite=finite, peak_gb=peak_gb,
                latents=latents.cpu())


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


def phase_rest_of_serving(model, tmp: Path) -> dict:
    """Phase 10 on the bf16 base model (see the module docstring), its
    checkpoint written to ``tmp / "ckpt"``; returns each kernels-vs-plain
    path's launches."""
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    t_phase = time.perf_counter()
    _checkpoint_round_trip(model, tmp / "ckpt")
    image = _generate(tmp / "ckpt", tmp / "out")
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


# ------------------------------------- phase 13: the serving entry points
# images through the graphs and through the eager kernel path (13a), the
# DeepCache artifact's (13b), requests timed (13c); the graph latents
# against the eager kernel path at the same seeds
# (8, 3 and 5 until the script outgrew its time limit)
AOT_IMAGES, AOT_EAGER_IMAGES, AOT_REQUESTS = 4, 2, 3
AOT_REL_L2_TOL = 1e-3  # the same kernels in the same order: 0 expected
AOT_KERNELS = ("gn_silu_fwd", "gn_silu_fwd_f32", "flash_fwd")


def _graph_nodes(graph) -> Optional[int]:
    """Nodes of a captured graph, by libcuda's ``cuGraphGetNodes``
    (``AOTPipeline`` keeps each graph), or None where it cannot be read."""
    import ctypes
    try:
        handle = graph.raw_cuda_graph()
        n = ctypes.c_size_t(0)
        rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(handle), None, ctypes.byref(n))
        return n.value if rc == 0 else None
    except (AttributeError, OSError, RuntimeError):
        return None


def _p90(values) -> float:
    """Nearest-rank 90th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.9 * len(ordered)) - 1)]


def _profiled(fn, label: str) -> tuple:
    """(result, wall ms, device busy ms, idle share) of one call under the
    profiler, its kernel groups logged."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    idle = _log_profile(prof, label, wall)
    return out, wall, (1 - idle) * wall, idle


def _sync_timed(fn, record: dict, kind):
    """``fn`` with each call's wall ms, between two synchronizes, appended
    to ``record[kind(args, kwargs)]``."""
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        record.setdefault(kind(a, kw), []).append(
            (time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def _step_stats(record: dict) -> str:
    return "; ".join(f"{k} median {statistics.median(ms):.2f} ms, p90 "
                     f"{_p90(ms):.2f} ms over {len(ms)} calls"
                     for k, ms in sorted(record.items()))


def _aot_case(label: str, model, root: Path, n_images: int, **pipe_kw):
    """Export at SERVE_SIZE^2, b1, STEPS steps, guidance 5, then
    ``AOTPipeline.load`` with capture: ``n_images`` images through the
    graphs and AOT_EAGER_IMAGES through the eager kernel path, UNet steps
    timed, one image of each profiled; the graph latents against the
    eager ones and against the plain versions, the decode graph against
    the eager decode.  Returns (metrics, the
    AOTPipeline)."""
    from sdxl_training_improvements_tpu_torch.aot import (
        AOTPipeline, export_text2img)
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    from sdxl_training_improvements_tpu_torch.training.validation import (
        latents_to_images)
    prompt = PROMPTS[:1]
    pipe = SDXLPipeline.from_model(model, **pipe_kw)
    art = export_text2img(pipe, root / label.split()[0], batch=1,
                          height=SERVE_SIZE, width=SERVE_SIZE,
                          num_inference_steps=STEPS, guidance_scale=5.0)
    _free()
    torch.cuda.synchronize()
    reserved, allocated = (torch.cuda.memory_reserved(),
                           torch.cuda.memory_allocated())
    _zero_launches()
    t0 = time.perf_counter()
    aot = AOTPipeline.load(art, model, pipe.tokenizers, device=DEVICE)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool_gib = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
    held_gib = (torch.cuda.memory_allocated() - allocated) / 2 ** 30
    nodes = {name: _graph_nodes(g) for name, g in aot.graphs.items()}
    log(f"phase 13 {label}: export + AOTPipeline.load {capture_s:.2f} s "
        f"(one eager warm-up and one capture a graph); {len(aot.graphs)} "
        f"graphs, nodes {nodes}; pool {pool_gib:.3f} GiB reserved, "
        f"{held_gib:.3f} GiB held by the static tensors; launches per "
        f"capture {aot.captured_launches}; the wrappers' counts over "
        f"warm-up and capture {_launches(AOT_KERNELS)}")
    unets = [g for g in aot.graphs if g.startswith("unet")]
    want = {"encode", "decode"} | ({"unet_deep", "unet_shallow"}
                                   if pipe.deep_cache > 1 else {"unet"})
    check(set(aot.graphs) == want, f"phase 13 {label}: graphs "
          f"{sorted(aot.graphs)}, want {sorted(want)}")
    for g in unets:  # the shallow stages of SDXL hold no attention
        check(all(aot.captured_launches[g].get(k, 0) > 0
                  for k in ("gn_silu_fwd",) + (
                      () if g == "unet_shallow" else ("flash_fwd",))),
              f"phase 13 {label}: {g} captured {aot.captured_launches[g]}")
    decode = aot.captured_launches.get("decode", {})
    check(decode.get("gn_silu_fwd_f32", 0) > 0,
          f"phase 13 {label}: decode captured {decode}")
    # through the graphs: images, then the compared latents
    steps, per_image = {}, []
    with mock.patch.object(aot, "_unet", _sync_timed(
            aot._unet, steps, lambda a, kw: a[0])):
        for i in range(n_images):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images = aot(prompt, seed=SEED + i)
            torch.cuda.synchronize()
            per_image.append(time.perf_counter() - t0)
            check(images[0].shape == (SERVE_SIZE, SERVE_SIZE, 3)
                  and images[0].dtype == np.uint8,
                  f"phase 13 {label}: image {images[0].shape} "
                  f"{images[0].dtype}")
    graph_lat = [aot.generate_latents(prompt, seed=SEED + i)
                 for i in range(AOT_EAGER_IMAGES)]
    _, g_wall, g_busy, g_idle = _profiled(
        lambda: aot.generate_latents(prompt, seed=SEED),
        f"phase 13 {label} graphs, one image's latents")
    launches = {k: aot.kernel_launches().get(k, 0) for k in AOT_KERNELS}
    # through the eager kernel path, the same seeds
    t2i = dict(height=SERVE_SIZE, width=SERVE_SIZE,
               num_inference_steps=STEPS, guidance_scale=5.0)
    e_steps, e_image, eager_lat = {}, [], []
    with mock.patch.object(model, "unet_apply", _sync_timed(
            model.unet_apply, e_steps,
            lambda a, kw: "shallow" if kw.get("deep_cache") is not None
            else "deep" if kw.get("return_deep") else "full")):
        for i in range(AOT_EAGER_IMAGES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat = pipe(prompt, seed=SEED + i, return_latents=True, **t2i)
            with torch.inference_mode():
                latents_to_images(model.decode_latents(lat))
            torch.cuda.synchronize()
            e_image.append(time.perf_counter() - t0)
            eager_lat.append(lat)
    _, e_wall, e_busy, e_idle = _profiled(
        lambda: pipe(prompt, seed=SEED, return_latents=True, **t2i),
        f"phase 13 {label} eager, one image's latents")
    rels = [((g - e).norm() / e.norm()).item()
            for g, e in zip(graph_lat, eager_lat)]
    equal = [torch.equal(g, e) for g, e in zip(graph_lat, eager_lat)]
    with _plain_ops():
        plain = pipe(prompt, seed=SEED, return_latents=True, **t2i)
    rel_plain = ((graph_lat[0] - plain).norm() / plain.norm()).item()
    finite = all(bool(torch.isfinite(g).all()) for g in graph_lat)
    # the decode graph against the eager decode of the same latents, and
    # the fp32 decode finite before the uint8 cast
    with torch.inference_mode():
        decoded = model.decode_latents(graph_lat[0].float()).float()
    dec_finite = bool(torch.isfinite(decoded).all())
    eager_img = latents_to_images(decoded)[0]
    graph_img = aot.decode(graph_lat[0])[0]
    dec_step = int(np.abs(graph_img.astype(np.int16)
                          - eager_img.astype(np.int16)).max())
    log(f"phase 13 {label}: UNet wall per step, graphs {_step_stats(steps)}"
        f"; eager {_step_stats(e_steps)}; s per image (decode included, "
        f"a synchronize around each UNet call): graphs median "
        f"{statistics.median(per_image):.3f} p90 {_p90(per_image):.3f} over "
        f"{len(per_image)}, eager median {statistics.median(e_image):.3f} "
        f"over {len(e_image)}; one image's latents profiled: graphs wall "
        f"{g_wall:.2f} ms, device busy {g_busy:.2f} ms ({g_busy / STEPS:.2f}"
        f" a step), idle {g_idle:.3f}; eager wall {e_wall:.2f} ms, busy "
        f"{e_busy:.2f} ms ({e_busy / STEPS:.2f} a step), idle {e_idle:.3f}")
    log(f"phase 13 {label}: graph latents vs the eager kernel path (same "
        f"seeds) rel L2 {rels} (tol {AOT_REL_L2_TOL:g}), torch.equal "
        f"{equal}; vs the plain versions {rel_plain:.3e} (tol "
        f"{SLICE_REL_L2_TOL:g}); finite {finite}; replays "
        f"{dict(aot.replays)}; launches (per capture x replays) {launches}")
    log(f"phase 13 {label}: decode graph vs the eager decode of the same "
        f"latents: max {dec_step} uint8 steps (bar 1), np.array_equal "
        f"{bool(np.array_equal(graph_img, eager_img))}; fp32 decode finite "
        f"{dec_finite}")
    check(finite, f"phase 13 {label}: graph latents not finite")
    check(dec_finite, f"phase 13 {label}: the decode is not finite")
    check(graph_img.shape == eager_img.shape and dec_step <= 1,
          f"phase 13 {label}: decode graph vs eager decode {dec_step} steps")
    check(max(rels) <= AOT_REL_L2_TOL, f"phase 13 {label}: graph vs eager "
          f"rel L2 {rels}")
    check(rel_plain <= SLICE_REL_L2_TOL, f"phase 13 {label}: graph vs "
          f"plain rel L2 {rel_plain}")
    for k in AOT_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched on the phase "
              f"13 {label} path")
    return dict(launches=launches, capture_s=capture_s, pool_gib=pool_gib,
                nodes=nodes, steps=steps, eager_steps=e_steps), aot


def _http(url: str, payload=None) -> tuple:
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _served_case(aot, root: Path) -> dict:
    """13c: ``serve.build_server`` on port 0 in a thread over 13a's
    artifact: /healthz, two concurrent requests with different seeds (the
    PNGs read back by ``png.read_png`` equal to ``AOTPipeline``'s images),
    a 400 on a batch mismatch, AOT_REQUESTS requests timed."""
    import base64
    import threading
    from sdxl_training_improvements_tpu_torch.png import read_png
    from sdxl_training_improvements_tpu_torch.serve import build_server
    server = build_server(aot, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    before = aot.kernel_launches()
    try:
        status, body = _http(url + "/healthz")
        check(status == 200 and body["ok"] and body["meta"]["batch"] == 1,
              f"phase 13 serve: /healthz {status} {body}")
        results = {}

        def hit(seed):
            results[seed] = _http(url + "/generate",
                                  {"prompts": [PROMPTS[1]], "seed": seed})

        seeds = (SEED + 100, SEED + 101)
        threads = [threading.Thread(target=hit, args=(s,)) for s in seeds]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        served = {}
        for s in seeds:
            status, body = results[s]
            check(status == 200 and body["seed"] == s,
                  f"phase 13 serve: seed {s}: {status}")
            path = root / f"served_{s}.png"
            path.write_bytes(base64.b64decode(body["images"][0]))
            served[s] = read_png(path)
        status, body = _http(url + "/generate", {"prompts": ["a", "b"]})
        check(status == 400 and body["artifact_batch"] == 1,
              f"phase 13 serve: batch mismatch gave {status} {body}")
        latency = []
        for i in range(AOT_REQUESTS):
            t0 = time.perf_counter()
            status, _ = _http(url + "/generate",
                              {"prompts": [PROMPTS[2]], "seed": i})
            latency.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"phase 13 serve: request {i}: {status}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    after = aot.kernel_launches()
    launches = {k: after.get(k, 0) - before.get(k, 0) for k in AOT_KERNELS}
    # the references, called directly, after the served path's count
    equal = {s: bool(np.array_equal(img, aot([PROMPTS[1]], seed=s)[0]))
             for s, img in served.items()}
    log(f"phase 13 serve: /healthz ok; two concurrent requests' PNGs equal "
        f"to AOTPipeline's images {equal}; batch mismatch 400; request "
        f"latency median {statistics.median(latency):.2f} ms over "
        f"{len(latency)} ({[round(v, 2) for v in latency]}); launches "
        f"{launches}")
    check(all(equal.values()), f"phase 13 serve: served PNGs differ {equal}")
    for k in AOT_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched on the phase "
              "13 serve path")
    return dict(launches=launches, latency_ms=latency)


def _generate_aot(ckpt: Path, out: Path) -> None:
    """13d: ``generate.main`` with ``--export-aot`` then ``--aot`` on phase
    10's checkpoint; a conflicting ``--steps`` (the parser's default,
    passed explicitly) exits before anything loads."""
    from sdxl_training_improvements_tpu_torch import generate
    from sdxl_training_improvements_tpu_torch.png import read_png
    art = out / "artifact"
    args = ["--model", str(ckpt), "--prompt", PROMPTS[0], "--seed",
            str(SEED)]
    size = ["--height", str(SERVE_SIZE), "--width", str(SERVE_SIZE),
            "--steps", str(STEPS)]
    for extra in (size + ["--export-aot", str(art)],
                  ["--aot", str(art), "--out", str(out / "aot")]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = generate.main(args + extra)
        torch.cuda.synchronize()
        log(f"phase 13 generate.main {' '.join(extra[-2:])}: rc {rc}, "
            f"{time.perf_counter() - t0:.2f} s (the checkpoint load and, "
            "for --aot, the capture included)")
        check(rc == 0, f"generate.main {extra}: rc {rc}")
        _free()
    img = read_png(out / "aot" / "000.png")
    check(img.shape == (SERVE_SIZE, SERVE_SIZE, 3) and img.dtype == np.uint8,
          f"generate.main --aot PNG {img.shape} {img.dtype}")
    try:
        generate.main(args + ["--aot", str(art), "--steps", "28"])
        exited = None
    except SystemExit as e:
        exited = str(e)
    log(f"phase 13 generate.main --aot --steps 28 (artifact {STEPS}): "
        f"{exited}")
    check(exited is not None and "conflicts" in exited,
          "generate.main --aot accepted a conflicting --steps")


def phase_serving_entry_points(model, tmp: Path) -> dict:
    """Phase 13 on phase 10's bf16 base and its checkpoint in ``tmp``
    (module docstring); returns each path's launches."""
    t_phase = time.perf_counter()
    root = tmp / "aot"
    euler, aot = _aot_case("euler", model, root, AOT_IMAGES)
    served = _served_case(aot, root)
    del aot
    _free()
    cached, aot = _aot_case("dpmpp_2m deep-cache 2", model, root,
                            AOT_IMAGES, sampler="dpmpp_2m", deep_cache=2)
    del aot
    _free()
    _generate_aot(tmp / "ckpt", root)
    log(f"phase 13 wall time {time.perf_counter() - t_phase:.1f} s")
    return {"euler (phase 13a)": euler["launches"],
            "dpmpp_2m deep-cache 2 (phase 13b)": cached["launches"],
            "serve.py (phase 13c)": served["launches"]}


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


def param_digest(params) -> torch.Tensor:
    """[leaves, 2] int64 on the host: per leaf (in order), the sum of its
    elements' bit patterns and their sum weighted by position (1..65521,
    repeating), over its contiguous copy; two runs that hold the same
    values hold the same digest."""
    rows = []
    for p in params.values():
        p = p.detach().contiguous()
        bits = p.view({2: torch.int16, 4: torch.int32}[p.element_size()]
                      ).reshape(-1).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        rows.append(torch.stack([bits.sum(), (bits * w).sum()]))
        del bits, w
    return torch.stack(rows).cpu()


def phase_train(model, cfg, kernels=TRAIN_KERNELS, size: int = SIZE,
                record: Optional[dict] = None) -> dict:
    """The training slice as the JAX entry drives it: ``make_optimizer`` ->
    ``make_train_step`` -> ``create_train_state`` -> ``TRAIN_STEPS`` steps
    at ``cfg``; the last step runs under the profiler.  Every kernel in
    ``kernels`` must launch in every step.  ``record`` receives what
    phase 15b holds its mesh steps to: the batch (on the host), the
    parameters' digests before and after, each step's loss and grad
    norm."""
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
    if record is not None:
        record.update(batch={k: v.cpu() for k, v in batch.items()},
                      initial=param_digest(state.params))
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
    if record is not None:
        record.update(final=param_digest(state.params),
                      losses=[r["loss"] for r in steps],
                      grad_norms=[r["grad_norm"] for r in steps])
    launches = {k: setup_launches[k] + sum(r["launches"][k] for r in steps)
                for k in names}
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    log(f"train kernel launches (setup + {TRAIN_STEPS} steps): {launches}; "
        f"copies of a non-contiguous dy before the GN backward: "
        f"{G.gn_silu_bwd_cuda.dy_copies}")
    del state, watched, step, optimizer
    torch.cuda.empty_cache()
    return dict(steps=steps, peak_gb=peak_gb, launches=launches)


def _loss_and_grads(model, cfg, batch, schedule, params) -> tuple:
    """One forward and backward of the configured method on ``batch``:
    (the loss, the gradients of ``params``)."""
    from sdxl_training_improvements_tpu_torch.training.methods import (
        get_method)
    loss, _ = get_method(cfg.training.method)(model.unet_apply, batch, None,
                                              schedule, cfg.model)
    return loss, torch.autograd.grad(loss, params)


def phase_train_parity(model, cfg, size: int = SIZE,
                       tols=(TRAIN_LOSS_REL_TOL, TRAIN_GRAD_REL_L2_TOL),
                       kernels=(), batch: Optional[dict] = None) -> dict:
    """One forward and backward at batch 1, size^2 (or on ``batch``), with
    replayed noise and timestep, through the kernels and through the plain
    versions: the loss and the relative L2 of all gradients together
    (within ``tols``), and the launches of ``kernels`` on the kernel
    path."""
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    if batch is None:
        batch = _train_batch(model, 1, gen, size)
    batch = dict(batch)
    shape = tuple(batch["vae_latents"].shape)
    batch["noise"] = torch.randn(shape, generator=gen, device=DEVICE)
    batch["timesteps"] = torch.tensor([500] * shape[0], device=DEVICE)
    schedule = NoiseSchedule.from_config(cfg)
    params = list(model.unet.parameters())
    where = f"b{shape[0]} latents {shape[2]}x{shape[3]}"

    def loss_and_grads():
        """(loss, gradients, ms of the second of two calls): the first
        call at a new batch size pays allocator growth."""
        for _ in range(2):
            grads = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = _loss_and_grads(model, cfg, batch, schedule, params)
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
    log(f"train parity ({cfg.training.mixed_precision}, {where}, "
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


# ------------------------------------------ phase 11: training entry point
NOVELAI_YAML = Path(__file__).resolve().parent / "configs" / \
    "novelai_v3_1024.yaml"
# (width, height) of the phase's images, four of each: one global batch
# of 4 per bucket, so 2 steps an epoch over 2 bucket shapes
ENTRY_IMAGE_SIZES = ((1024, 1024), (1216, 832))
IMAGE_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / \
    "images"
# the phase's 8 files in index order (the first four at the first size):
# a committed JPEG or WebP fixture, or how the script writes the PNG
ENTRY_FILES = ("entry_baseline_420_rst.jpg", "entry_progressive_420.jpg",
               "palette", "entry_lossy_alpha.webp", "entry_baseline_444.jpg",
               "entry_gray.jpg", "adam7", "entry_lossless.webp")
# the decode check's timed fixtures: baseline 4:2:0 and progressive 4:2:0
# JPEG, lossy WebP with alpha (1024x1024) and lossless WebP (1216x832)
DECODE_TIMED = ENTRY_FILES[:2] + ENTRY_FILES[3::4]
ENTRY_CAPTIONS = ("masterpiece, best quality, 1girl, solo, smile",
                  "landscape, mountains, lake, sunset, scenery",
                  "1boy, armor, sword, castle, night",
                  "cat, window, indoors, plant, sunlight")
# the precompute's fp32 VAE encoder and the bf16 train step, and the
# startup probe of create_train_state
ENTRY_KERNELS = TRAIN_KERNELS + ("gn_silu_fwd_f32", "probe")
# one image's latents through the fp32 VAE encoder, kernels against plain:
# the two differ in the GroupNorm statistics' summation order only
ENTRY_LATENT_REL_L2_TOL = 1e-3
# run A: steps 1-2 meet each bucket shape first (3 epochs, steps 3-4
# timed and 5-6 profiled, until the script outgrew its time limit)
ENTRY_EPOCHS = 2
ENTRY_TIMED = (3, 3)  # run A's step timed as one window (warm)
ENTRY_PROFILED = (4, 4)  # and the step profiled as another
# the precompute's rate: 16 seeded PNGs (8 at each bucket) copied to 4
# paths each, every path its own cache entry (16 batches of 4; 16 paths
# each until the script outgrew its time limit)
ENTRY_BULK_UNIQUE, ENTRY_BULK_COPIES = 16, 2


def _entry_config(root: Path, name: str, images: str = "images",
                  cache: str = "cache", log_every: Optional[int] = None,
                  **training) -> Path:
    """``configs/novelai_v3_1024.yaml`` as the port's reader loads it, with
    the phase's cuts (each logged by the caller), written to ``root``."""
    from sdxl_training_improvements_tpu_torch import _yaml
    raw = _yaml.load_file(NOVELAI_YAML)
    raw["model"]["pretrained_model_name"] = str(root / "no-checkpoint")
    raw["training"].update(gradient_accumulation_steps=1, **training)
    raw["data"]["train_data_dir"] = [str(root / images)]
    logging_cfg = {"log_dir": str(root / "logs")}
    if log_every is not None:
        logging_cfg["log_every"] = log_every
    raw["global_config"] = {"cache": {"cache_dir": str(root / cache)},
                            "logging": logging_cfg}
    path = root / f"{name}.yaml"
    path.write_text(_yaml.dump(raw))
    return path


def _png_bytes(ihdr: tuple, rows: np.ndarray, plte: bytes = b"") -> bytes:
    """A PNG of IHDR fields ``ihdr`` (width, height, depth, color type,
    interlace) whose data is ``rows`` (filter bytes included), with a
    PLTE chunk when given."""
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    w, h, depth, color, interlace = ihdr
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, interlace))
            + (chunk(b"PLTE", plte) if plte else b"")
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _write_paeth_png(path: Path, img: np.ndarray) -> None:
    """HxWx3 uint8 -> an RGB PNG whose rows all use the Paeth filter (what
    Pillow's adaptive encoder picks for most rows of a photo, and the
    slowest filter to undo)."""
    h, w, _ = img.shape
    x = img.astype(np.int16).reshape(h, w * 3)
    left, up, corner = (np.zeros_like(x) for _ in range(3))
    left[:, 3:], up[1:], corner[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    p = left + up - corner
    pa, pb, pc = (np.abs(p - v) for v in (left, up, corner))
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, corner))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8),
                           ((x - pred) & 0xFF).astype(np.uint8)], 1)
    path.write_bytes(_png_bytes((w, h, 8, 2, 0), rows))


def _write_palette_png(path: Path, img: np.ndarray) -> np.ndarray:
    """HxWx3 uint8 -> an 8-bit palette PNG of its 3-3-2 bit colors (filter
    0 rows); returns the indices."""
    h, w, _ = img.shape
    idx = ((img[..., 0] >> 5) << 5 | (img[..., 1] >> 5) << 2
           | img[..., 2] >> 6).astype(np.uint8)
    k = np.arange(256)
    plte = np.stack([(k >> 5) * 36, ((k >> 2) & 7) * 36, (k & 3) * 85],
                    -1).astype(np.uint8)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), idx], 1)
    path.write_bytes(_png_bytes((w, h, 8, 3, 0), rows, plte.tobytes()))
    return idx


def _write_adam7_png(path: Path, img: np.ndarray) -> None:
    """HxWx3 uint8 -> an Adam7-interlaced RGB PNG (filter 0 rows, each
    pass on its own)."""
    from sdxl_training_improvements_tpu_torch.png import _ADAM7
    h, w, _ = img.shape
    parts = []
    for x0, y0, dx, dy in _ADAM7:
        sub = img[y0::dy, x0::dx]
        if sub.size:
            sub = sub.reshape(sub.shape[0], -1)
            parts.append(np.concatenate(
                [np.zeros((sub.shape[0], 1), np.uint8), sub], 1).reshape(-1))
    path.write_bytes(_png_bytes((w, h, 8, 2, 1), np.concatenate(parts)))


def _entry_images(folder: Path, n: int = 8, mixed: bool = True,
                  first_bucket: bool = False) -> None:
    """Images with tag captions in ``folder``, the first half at the
    first of ENTRY_IMAGE_SIZES, the rest at the second: with ``mixed``
    (and n = 8) ENTRY_FILES, the JPEG and WebP fixtures copied and the
    PNGs written here; else ``n`` seeded Paeth PNGs; ``first_bucket``:
    the first half alone (one global batch of 4 at 1024x1024, one step an
    epoch).  Each written PNG is read back through the port's reader
    against its samples."""
    import shutil

    from sdxl_training_improvements_tpu_torch.png import read_png
    rng = np.random.default_rng(SEED)
    folder.mkdir(parents=True)
    for i in range(n // 2 if first_bucket else n):
        w, h = ENTRY_IMAGE_SIZES[2 * i // n]
        kind = ENTRY_FILES[i] if mixed else "paeth"
        path = folder / (_entry_name(i) if mixed else f"{i:02d}.png")
        path.with_suffix(".txt").write_text(ENTRY_CAPTIONS[i % 4])
        if kind.endswith((".jpg", ".webp")):
            shutil.copyfile(IMAGE_FIXTURES / kind, path)
            continue
        # smooth gradients plus noise: a photo-like image
        y, x = np.mgrid[0:h, 0:w]
        base = np.stack([x * 255 // w, y * 255 // h,
                         (x + y) * 255 // (w + h)], -1)
        img = np.clip(base + rng.integers(-20, 21, (h, w, 3)), 0, 255
                      ).astype(np.uint8)
        if kind == "palette":
            img = _write_palette_png(path, img)
        elif kind == "adam7":
            _write_adam7_png(path, img)
        else:
            _write_paeth_png(path, img)
        check(np.array_equal(read_png(path), img),
              f"{path} does not read back")


def _entry_name(i: int) -> str:
    """The file name of phase 11's image ``i``."""
    return f"{i:02d}" + (Path(ENTRY_FILES[i]).suffix or ".png")


def phase_decode() -> dict:
    """The decode check: every JPEG and WebP fixture through the port's
    reader (``images.read_rgb`` and ``read_gray``) on the card's host,
    each sha256 against the Pillow digest in the fixtures' manifest; the
    timed fixtures' median host ms per megapixel over 5 decodes after one
    warm-up."""
    import hashlib

    from sdxl_training_improvements_tpu_torch import images
    smi = _card(DEVICE)
    manifest = json.loads((IMAGE_FIXTURES / "manifest.json").read_text())
    mismatches = []
    counts = {}
    for name, entry in sorted(manifest["files"].items()):
        suffix = Path(name).suffix
        counts[suffix] = counts.get(suffix, 0) + 1
        rgb = images.read_rgb(IMAGE_FIXTURES / name)
        gray = images.read_gray(IMAGE_FIXTURES / name)
        if (hashlib.sha256(rgb.tobytes()).hexdigest(),
                hashlib.sha256(gray.tobytes()).hexdigest()) != (
                    entry["rgb_sha256"], entry["l_sha256"]):
            mismatches.append(name)
    ms_per_mp = {}
    for name in DECODE_TIMED:
        path = IMAGE_FIXTURES / name
        images.read_rgb(path)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            rgb = images.read_rgb(path)
            times.append((time.perf_counter() - t0) * 1e3)
        ms_per_mp[name] = statistics.median(times) / (
            rgb.shape[0] * rgb.shape[1] / 1e6)
    log(f"decode check ({smi}; the card's host): {counts.get('.jpg', 0)} "
        f"JPEG and {counts.get('.webp', 0)} WebP fixtures, "
        f"{len(mismatches)} mismatches {mismatches} against Pillow "
        f"{manifest['pillow']} (libjpeg-turbo {manifest['libjpeg_turbo']}, "
        f"libwebp {manifest['libwebp']}); host ms per megapixel: "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms_per_mp.items()))
    check(not mismatches, f"decode check: {mismatches} differ from Pillow")
    return dict(files=len(manifest["files"]), by_suffix=counts,
                mismatches=mismatches, ms_per_mp=ms_per_mp, card=smi)


def _run_main(argv, timed=None, profiled=None, events=False) -> tuple:
    """``main.main(argv)`` on the card: (its trainer, each step's latents
    shape and loss, the windows' wall ms and the profiled window's
    profiler).  The losses stay on the device until the run has ended, so
    the loop's own reads are its only host syncs; ``timed`` and
    ``profiled`` are (first, last) step numbers of a window timed from a
    synchronize before its first step's call to one after its last
    step's return, the second under the profiler.  ``events``: each step
    also records the train step's CUDA events, read after the run as its
    forward+backward, clip and optimizer ms."""
    from torch.profiler import ProfilerActivity, profile

    from sdxl_training_improvements_tpu_torch import main as entry
    from sdxl_training_improvements_tpu_torch.training import loop
    trainers, steps, windows = [], [], {}
    make_step, init = loop.make_train_step, loop.SDXLTrainer.__init__
    stack = ExitStack()
    spans = {k: v for k, v in (("timed", timed), ("profiled", profiled))
             if v is not None}

    def timed_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed_step(state, batch):
            n = len(steps) + 1
            for name, (first, _) in spans.items():
                if n == first:
                    if name == "profiled":
                        windows["prof"] = stack.enter_context(
                            profile(activities=[ProfilerActivity.CUDA]))
                    torch.cuda.synchronize()
                    windows[name] = time.perf_counter()
            ev = {} if events else None
            state, metrics = step(state, batch, ev)
            steps.append(dict(loss=metrics["loss"].detach(),
                              shape=list(batch["vae_latents"].shape),
                              events=ev))
            for name, (_, last) in spans.items():
                if n == last:
                    torch.cuda.synchronize()
                    windows[name] = (time.perf_counter() - windows[name]) * 1e3
                    if name == "profiled":
                        stack.close()
            return state, metrics
        return timed_step

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    with mock.patch.object(loop, "make_train_step", timed_make_step), \
            mock.patch.object(loop.SDXLTrainer, "__init__", recording_init):
        rc = entry.main(argv)
    check(rc == 0, f"main.main exit code {rc}")
    for s in steps:
        s["loss"] = s["loss"].item()
        ev = s.pop("events")
        if ev:
            s.update(_event_ms(ev))
    return trainers[0], steps, windows


def _event_ms(ev: dict) -> dict:
    """A train step's CUDA events (``make_train_step``'s ``events``) as
    the ms of its forward+backward, clip and optimizer parts."""
    return dict(fwd_bwd_ms=ev["start"].elapsed_time(ev["backward"]),
                clip_ms=ev["backward"].elapsed_time(ev["clip"]),
                opt_ms=ev["clip"].elapsed_time(ev["update"]))


def _state_snapshot(state) -> tuple:
    """(a host copy of every tensor of the train state, the step and the
    generators' states); a synchronize first, for the host-streamed
    state's last copies."""
    from sdxl_training_improvements_tpu_torch.training import checkpoints
    torch.cuda.synchronize()
    tensors, meta = checkpoints.flatten_train_state(state)
    return {k: v.detach().to("cpu", copy=True)
            for k, v in tensors.items()}, meta


def _entry_latents_check(model, root: Path) -> dict:
    """The latents of the first image of each size through the fp32 VAE
    encoder, kernels against the plain versions (the same draw): rel L2
    by image."""
    from sdxl_training_improvements_tpu_torch.data.buckets import Bucket
    from sdxl_training_improvements_tpu_torch.data.dataset import (
        prepare_image_array)
    from sdxl_training_improvements_tpu_torch.images import read_rgb
    f = model.vae.config.downscale_factor
    rels = {}
    for i, (w, h) in zip((0, 4), ENTRY_IMAGE_SIZES):
        name = _entry_name(i)
        arr, _, _ = prepare_image_array(read_rgb(root / "images" / name),
                                        Bucket(w, h))
        px = torch.from_numpy(arr)[None].to(DEVICE)
        noise = torch.randn(1, 4, h // f, w // f, device=DEVICE,
                            generator=torch.Generator(DEVICE).manual_seed(SEED))
        with torch.no_grad():
            lat = model.encode_images(px, noise=noise)
            with _plain_ops():
                ref = model.encode_images(px, noise=noise)
        rels[name] = ((lat - ref).norm() / ref.norm()).item()
        log(f"phase 11 precompute latents ({name}, {w}x{h}), kernels vs "
            f"plain: rel L2 {rels[name]:.3e} (tol "
            f"{ENTRY_LATENT_REL_L2_TOL:g})")
        check(rels[name] <= ENTRY_LATENT_REL_L2_TOL,
              f"phase 11 latents {name} rel {rels[name]}")
    return rels


def _entry_precompute_rate(trainer, root: Path) -> dict:
    """The trainer's own precompute (``SDXLTrainer._precompute_into``) over
    ENTRY_BULK_UNIQUE * ENTRY_BULK_COPIES PNGs into a fresh cache: its
    images/s and stage seconds."""
    import shutil
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.data.dataset import (
        create_dataset)
    src, bulk = root / "bulk_src", root / "bulk"
    _entry_images(src, ENTRY_BULK_UNIQUE, mixed=False)
    bulk.mkdir()
    for png in sorted(src.glob("*.png")):
        for r in range(ENTRY_BULK_COPIES):
            for suffix in (".png", ".txt"):
                shutil.copyfile(png.with_suffix(suffix),
                                bulk / f"{png.stem}_{r:02d}{suffix}")
    shutil.rmtree(src)
    cfg = Config.from_yaml(_entry_config(root, "bulk", images="bulk",
                                         cache="bulk_cache"))
    ds = create_dataset(cfg)
    trainer._precompute_into(ds, label="bulk")
    stats = dict(ds.last_precompute_stats)
    n = ENTRY_BULK_UNIQUE * ENTRY_BULK_COPIES
    log(f"phase 11 precompute rate: {stats['images']} of {n} PNGs (all "
        f"rows Paeth; {ENTRY_BULK_UNIQUE} seeded images, half at each of "
        f"{ENTRY_IMAGE_SIZES}, each at {ENTRY_BULK_COPIES} paths) in "
        f"{stats['seconds']:.3f} s: {stats['images_per_sec']:.3f} images/s "
        f"(batch {cfg.training.batch_size}; stage seconds: decode "
        f"{stats['stage_decode_cpu_s']} on the host's threads, encode "
        f"{stats['stage_encode_device_s']}, waiting on decode "
        f"{stats['stage_decode_wait_s']})")
    check(stats["images"] == n, f"precompute cached {stats['images']} of {n}")
    shutil.rmtree(bulk)
    shutil.rmtree(root / "bulk_cache")
    return stats


def _entry_cached_batch(trainer, name: str) -> dict:
    """A b1 batch of the cache's entry of image ``name``, on the card."""
    ds = trainer.dataset
    i = [Path(p).name for p in ds.image_paths].index(name)
    return {k: torch.from_numpy(v).to(DEVICE)
            for k, v in ds.get_batch([i]).items()}


def _entry_conv_cost(model, cfg, batch) -> dict:
    """Device ms of the convolutions, and of all kernels, in one b1
    forward and backward on ``batch`` under the profiler: with cuDNN's
    deterministic algorithms (as the trainer runs) and with the process's
    defaults (no autotuning either way)."""
    from torch.profiler import ProfilerActivity, profile

    from sdxl_training_improvements_tpu_torch.training.loop import (
        deterministic_convolutions)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    schedule = NoiseSchedule.from_config(cfg)
    params = list(model.unet.parameters())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    batch = dict(batch, timesteps=torch.tensor([500], device=DEVICE),
                 noise=torch.randn(batch["vae_latents"].shape, generator=gen,
                                   device=DEVICE))
    res = {}
    for label, ctx in (("deterministic", deterministic_convolutions),
                       ("default", lambda _: ExitStack())):
        with ctx(torch.device(DEVICE)):
            _loss_and_grads(model, cfg, batch, schedule, params)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _loss_and_grads(model, cfg, batch, schedule, params)
                torch.cuda.synchronize()
        conv = total = 0.0
        for name, ms in _device_events(prof):
            total += ms
            if _kernel_group(name) == "convolution":
                conv += ms
        res[label] = dict(conv_ms=conv, total_ms=total)
    shape = list(batch["vae_latents"].shape)
    log(f"phase 11 cuDNN algorithms, one b1 forward+backward (latents "
        f"{shape}), device ms of the convolutions / of all kernels: "
        f"deterministic {res['deterministic']['conv_ms']:.2f} / "
        f"{res['deterministic']['total_ms']:.2f}, default "
        f"{res['default']['conv_ms']:.2f} / "
        f"{res['default']['total_ms']:.2f}")
    torch.cuda.empty_cache()
    return res


def phase_entry_point() -> dict:
    """Phase 11: the training entry point, ``main.main``, at full
    SDXL-base width on the recipe of ``configs/novelai_v3_1024.yaml``, as
    the port's YAML reader loads it, over the 8 images of ENTRY_FILES:
    run A (ENTRY_EPOCHS epochs, no saves; one window of warm steps timed and
    one profiled), then the precompute's rate over a larger set, the
    kernels against plain on the landscape bucket, and run B (1 epoch
    with the final checkpoint, then ``--resume`` to ENTRY_EPOCHS), whose
    final parameters, optimizer state, step and generators must be
    ``torch.equal`` to run A's."""
    import shutil
    from sdxl_training_improvements_tpu_torch.data.cache import CacheManager
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_entry_"))
    n_steps = 2 * ENTRY_EPOCHS
    try:
        _entry_images(root / "images")
        log(f"phase 11: config {NOVELAI_YAML.name} (BASELINE config 2: "
            "ddpm, v-prediction, ZTSNR, MinSNR 5, adamw_bf16, bf16, "
            "micro-batch 1, no remat) with these cuts: data, cache, log "
            "and output paths in a temporary directory; "
            "gradient_accumulation_steps 4 -> 1 (global batch 4 as 4 "
            "micro-steps of 1; for time); model.pretrained_model_name -> "
            f"a path that does not exist (seeded weights); num_epochs "
            f"{ENTRY_EPOCHS} (run A), 1 then {ENTRY_EPOCHS} (run B); "
            "logging.log_every 10 -> 1 in run B's first part only (its "
            "metric lines); save_every 0, save_best false and "
            "save_final_model false except run B's first part (final "
            "checkpoint only); 8 images, 4 at 1024x1024 and 4 at "
            f"1216x832: {ENTRY_FILES}")
        no_saves = dict(save_every=0, save_best=False)
        cfg_a = _entry_config(root, "run_a", num_epochs=ENTRY_EPOCHS,
                              save_final_model=False, **no_saves)
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, steps, windows = _run_main(
            ["--config", str(cfg_a), "--output-dir", str(root / "out_a"),
             "--device", DEVICE], timed=ENTRY_TIMED, profiled=ENTRY_PROFILED)
        wall_s = time.perf_counter() - t0
        launches = _launches(ENTRY_KERNELS)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        stats = trainer.dataset.last_precompute_stats
        cache = CacheManager(root / "cache")
        shapes = sorted(tuple(e["latent_shape"]) for e in cache.index.values())
        log(f"phase 11 precompute in run A: {stats['images']} images, "
            f"{stats['seconds']:.3f} s (a smoke reading, not a rate: the "
            f"rate is timed below; stage seconds: decode "
            f"{stats['stage_decode_cpu_s']} on the host's threads, encode "
            f"{stats['stage_encode_device_s']}, waiting on decode "
            f"{stats['stage_decode_wait_s']}); cache latent shapes {shapes}")
        f = trainer.model.vae.config.downscale_factor
        check(shapes == sorted((4, h // f, w // f) for w, h in
                               ENTRY_IMAGE_SIZES for _ in range(4)),
              f"cache entries {shapes}")
        for i, s in enumerate(steps):
            log(f"phase 11 run A step {i + 1}: latents {s['shape']}, loss "
                f"{s['loss']:.6f}")
        check(len(steps) == n_steps and trainer.state.step == n_steps,
              f"run A: {len(steps)} steps, state step {trainer.state.step}")
        check(all(np.isfinite(s["loss"]) for s in steps),
              "phase 11: a loss is not finite")
        n_timed = ENTRY_TIMED[1] - ENTRY_TIMED[0] + 1
        n_prof = ENTRY_PROFILED[1] - ENTRY_PROFILED[0] + 1
        step_ms = windows["timed"] / n_timed
        idle = _log_profile(windows["prof"], f"phase 11 run A steps "
                            f"{ENTRY_PROFILED[0]}-{ENTRY_PROFILED[1]} "
                            "(no syncs inside the window)",
                            windows["profiled"])
        busy_ms = (1 - idle) * windows["profiled"] / n_prof
        log(f"phase 11 run A: main.main {wall_s:.2f} s (model build, "
            f"precompute, {n_steps} steps); steps {ENTRY_TIMED[0]}-"
            f"{ENTRY_TIMED[1]} {windows['timed']:.2f} ms from a synchronize "
            f"before to one after ({step_ms:.2f} ms a step, log_every as "
            f"configured); steps {ENTRY_PROFILED[0]}-{ENTRY_PROFILED[1]} "
            f"profiled: {busy_ms:.2f} ms of device time a step, idle share "
            f"{idle:.3f}; peak memory {peak_gb:.2f} GiB; launches "
            f"{launches}")
        for k, n in launches.items():
            check(n > 0, f"kernel {k} was not launched on the entry path")
        ref, ref_meta = _state_snapshot(trainer.state)
        trainer.state = None
        _free()
        rate = _entry_precompute_rate(trainer, root)
        rels = _entry_latents_check(trainer.model, root)
        # the landscape bucket through the kernels and the plain versions
        # (phase 3 holds each kernel at its sites)
        batch = _entry_cached_batch(trainer, _entry_name(4))
        parity = phase_train_parity(
            trainer.model, trainer.config, batch=batch,
            kernels=tuple(k for k in TRAIN_KERNELS if k != "fused_adamw"))
        conv = _entry_conv_cost(trainer.model, trainer.config, batch)
        del trainer, batch
        _free()

        free_gb = shutil.disk_usage(root).free / 2 ** 30
        log(f"phase 11 run B: free disk {free_gb:.1f} GiB before the save")
        cfg_b1 = _entry_config(root, "run_b1", num_epochs=1, log_every=1,
                               save_final_model=True, **no_saves)
        trainer, steps_b1, _ = _run_main(
            ["--config", str(cfg_b1), "--output-dir", str(root / "out_b"),
             "--device", DEVICE])
        save = dict(trainer.last_save)
        del trainer
        _free()
        final = root / "out_b" / "final_checkpoint"
        ckpt_gb = sum(f.stat().st_size for f in final.rglob("*")
                      if f.is_file()) / 2 ** 30
        log(f"phase 11 run B: {len(steps_b1)} steps, then the final "
            f"checkpoint {ckpt_gb:.2f} GiB on disk (train state "
            f"{save['state_gib']:.2f} GiB snapshot to host in "
            f"{save['state_s']:.2f} s, written in the background; diffusers "
            f"export {save['export_gib']:.2f} GiB in {save['export_s']:.2f} "
            f"s; all on disk {save['join_s']:.2f} s after the export)")
        cfg_b2 = _entry_config(root, "run_b2", num_epochs=ENTRY_EPOCHS,
                               save_final_model=False, **no_saves)
        trainer, steps_b2, _ = _run_main(
            ["--config", str(cfg_b2), "--output-dir", str(root / "out_b"),
             "--resume", "--device", DEVICE])
        log(f"phase 11 run B: resumed in {trainer.restore_seconds:.2f} s, "
            f"then {len(steps_b2)} steps; losses "
            f"{[round(s['loss'], 6) for s in steps_b1 + steps_b2]} vs run "
            f"A {[round(s['loss'], 6) for s in steps]}")
        got, meta = _state_snapshot(trainer.state)
        del trainer
        _free()
        differ = [k for k in ref if not torch.equal(ref[k], got[k])]
        log(f"phase 11 resume vs uninterrupted: {len(ref)} tensors, "
            f"{len(differ)} differ {differ[:3]}; step {meta['step']} vs "
            f"{ref_meta['step']}; generators equal {meta == ref_meta}")
        check(set(got) == set(ref) and not differ,
              f"resume: tensors differ {differ[:3]}")
        check(meta == ref_meta, "resume: step or generator states differ")
        log_file = root / "logs" / "training.log"
        metric_steps = {int(ln.split("metrics step=")[1].split()[0])
                        for ln in log_file.read_text().splitlines()
                        if "metrics step=" in ln}
        log(f"phase 11 {log_file.name}: metric lines at steps "
            f"{sorted(metric_steps)}")
        check({1, 2} <= metric_steps,
              "phase 11: run B's metric lines (log_every 1) missing")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not root.exists(), f"{root} was not deleted")
    log(f"phase 11 wall time {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, steps=steps, step_ms=step_ms, idle=idle,
                busy_ms=busy_ms, peak_gb=peak_gb, save=save,
                checkpoint_gb=ckpt_gb, precompute=rate, latents=rels,
                parity=parity, conv=conv)


# -------------------------------- phase 12: the remaining training features
# 12a: the entry point with LoRA (rank 4, the default targets) and weight
# EMA; the kernels of the bf16 step without the fused AdamW (the LoRA tree
# is fp32: adamw_bf16 takes its exact fp32 path), the precompute's fp32
# VAE encoder and the startup probe
LORA_KERNELS = ("gn_silu_fwd", "gn_silu_bwd", "flash_fwd", "flash_bwd_dq",
                "flash_bwd_dkv", "gn_silu_fwd_f32", "probe")
# over phase 11's first bucket, one step an epoch (its 8 images, steps
# 3-4 profiled, until the script outgrew its time limit)
LORA_EPOCHS = 2
LORA_PROFILED = (2, 2)
LORA_EMA_DECAY = 0.9999
# seeded LoRA trees with up ~ N(0, std^2).  At 1e-3 (the scale of a
# trained adapter's delta) the kernels are held against their plain
# versions at phase 7's bars.  At 0.05 the adapters outweigh the seeded
# base projections: logits spread by up to ~250, the softmax nearly one-hot,
# and every bf16 path's LoRA gradients lie far from the fp32 ones (the two
# plain paths' too, and apart from each other), so there each bf16 path is
# held against an fp32 reference (the UNet cast to fp32, plain ops): the
# kernels' error may be at most LORA_ERR_RATIO times their plain versions'
# (the same formulas: Delta = rowsum(dO * O) from the saved 16-bit output,
# as JAX's Pallas backward forms it; plain attention differentiates the
# softmax from fp32 probabilities and is logged beside them), and the fp32
# kernels are held against that reference at phase 7's gradient bar
LORA_UP_STD_TRAINED, LORA_UP_STD_LARGE = 1e-3, 0.05
LORA_LARGE_TIMESTEPS = (500, 900)
LORA_ERR_RATIO = 1.25
# 12b-12e: the optimizers through the API at the entry point's recipe
# (b4 at 1024^2 as 4 micro-steps of 1, no remat); the kernels of the bf16
# step and the probe, plus the fused AdamW under int8 moments
OPT_KERNELS = ("gn_silu_fwd", "gn_silu_bwd", "flash_fwd", "flash_bwd_dq",
               "flash_bwd_dkv", "probe")
SF_STEPS, SF_WARMUP, SOAP_STEPS, INT8_STEPS, EMA_STEPS = 3, 2, 2, 2, 2
# SOAP at full width does not fit 80 GB with its defaults (the reckoning
# is logged): the cuts, in the order tried
SOAP_CUTS = (("tpu", "grad_accum_dtype", "bfloat16"),
             ("optimizer", "max_precond_dim", 4096))
SOAP_FIT_GIB = 70  # of the card's 79.2 GiB, the rest for eigh and temps
INT8_LEAF = (10240, 1280)  # the largest bf16 leaf (GEGLU proj)
TINY_IMAGE = {"min_size": [32, 32], "max_size": [96, 96], "bucket_step": 16}


def _lora_config(root: Path, name: str, **training) -> Path:
    return _entry_config(root, name, lora={"enabled": True},
                         ema_decay=LORA_EMA_DECAY, save_every=0,
                         save_best=False, **training)


def _lora_seeded_tree(trainer, up_std: float) -> dict:
    """The trained tree with its up factors drawn anew, N(0, up_std^2)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    return {k: (torch.randn(v.shape, generator=gen, device=DEVICE)
                * up_std if k.endswith(".up") else v.detach().clone()
                ).requires_grad_(True)
            for k, v in trainer.state.params.items()}


def _rel_l2(names, grads, ref, keep=lambda k: True) -> float:
    pairs = [(a.double(), b.double())
             for k, a, b in zip(names, grads, ref) if keep(k)]
    num = sum((a - b).square().sum() for a, b in pairs)
    return (num / sum(b.square().sum() for _, b in pairs)).sqrt().item()


def _by_group(names, grads, ref) -> dict:
    qk = lambda k: ".to_q." in k or ".to_k." in k  # noqa: E731
    return {group: round(_rel_l2(names, grads, ref, keep), 6)
            for group, keep in (("all", lambda k: True), ("to_q/to_k", qk),
                                ("to_v/to_out", lambda k: not qk(k)))}


def _lora_checks(trainer, batch: dict) -> dict:
    """On run A's trainer and one b1 cache entry, with seeded trees: the
    merge path against the branch path (dropout 0) through the kernels;
    at the trained scale, the loss and LoRA gradients through the kernels
    against the plain versions (phase 7's bars); at the large scale, every
    bf16 path and the fp32 kernels against an fp32 plain reference (the
    UNet is left in fp32: the caller drops the trainer)."""
    from sdxl_training_improvements_tpu_torch.training.methods import (
        get_method)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    cfg = trainer.config
    small = _lora_seeded_tree(trainer, LORA_UP_STD_TRAINED)
    large = _lora_seeded_tree(trainer, LORA_UP_STD_LARGE)
    names = list(small)
    base = trainer.model.trainable_params()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    shape = tuple(batch["vae_latents"].shape)
    batch = dict(batch, noise=torch.randn(shape, generator=gen,
                                          device=DEVICE))
    schedule = NoiseSchedule.from_config(cfg)
    where = f"b1 latents {shape[2]}x{shape[3]}"

    def apply(tree, **kw):
        return functools.partial(trainer.lora_apply, tree, base_params=base,
                                 **kw)

    def at(t):
        return dict(batch, timesteps=torch.tensor([t] * shape[0],
                                                  device=DEVICE))

    with torch.no_grad():
        b = at(500)
        x = schedule.add_noise(b["vae_latents"].float(), b["noise"],
                               b["timesteps"])
        args = (x, b["timesteps"], b["prompt_embeds"],
                b["pooled_prompt_embeds"], b["time_ids"])
        merged = apply(large, branch=False)(*args).float()
        branched = apply(large, branch=True)(*args).float()
    rel_mb = ((merged - branched).norm() / merged.norm()).item()
    del merged, branched
    log(f"phase 12a merge vs branch (dropout 0), one {where} forward "
        f"through the kernels, seeded tree (up ~ N(0, "
        f"{LORA_UP_STD_LARGE}^2)): rel L2 {rel_mb:.3e} (tol "
        f"{SLICE_REL_L2_TOL:g})")
    check(rel_mb <= SLICE_REL_L2_TOL, f"12a merge vs branch {rel_mb}")

    def loss_and_grads(tree, t, plain=ExitStack):
        with plain():
            loss, _ = get_method(cfg.training.method)(apply(tree), at(t),
                                                      None, schedule,
                                                      cfg.model)
            grads = torch.autograd.grad(loss, list(tree.values()))
        return loss.item(), [g.detach() for g in grads]

    _zero_launches()
    loss, grads = loss_and_grads(small, 500)
    launches = _launches(LORA_KERNELS[:5])
    plain_loss, plain_grads = loss_and_grads(small, 500,
                                             _kernels_plain_versions)
    rel = _rel_l2(names, grads, plain_grads)
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    trained = dict(loss_rel=loss_rel, grad_rel_l2=rel,
                   by_group=_by_group(names, grads, plain_grads))
    log(f"phase 12a LoRA parity, trained scale (up ~ N(0, "
        f"{LORA_UP_STD_TRAINED}^2), {where}, t=500): loss kernels "
        f"{loss:.6e}, their plain versions {plain_loss:.6e} (rel "
        f"{loss_rel:.3e}, tol {TRAIN_LOSS_REL_TOL:g}); {len(grads)} LoRA "
        f"gradients, kernels vs their plain versions rel L2 {rel:.3e} (tol "
        f"{TRAIN_GRAD_REL_L2_TOL:g}), by group {trained['by_group']}; "
        f"launches {launches}")
    check(loss_rel <= TRAIN_LOSS_REL_TOL, f"12a parity loss {loss_rel}")
    check(rel <= TRAIN_GRAD_REL_L2_TOL, f"12a parity gradients {rel}")
    check(all(n > 0 for n in launches.values()),
          f"12a parity: a kernel was not launched {launches}")
    del grads, plain_grads

    # the large scale: bf16 paths first, then the UNet in fp32
    paths = {}
    for t in LORA_LARGE_TIMESTEPS:
        for label, plain in (("kernels", ExitStack),
                             ("plain versions", _kernels_plain_versions),
                             ("plain attention", _plain_ops)):
            paths[t, label] = loss_and_grads(large, t, plain)
    trainer.model.unet.float()
    for t in LORA_LARGE_TIMESTEPS:
        _zero_launches()
        paths[t, "fp32 kernels"] = loss_and_grads(large, t)
        f32_launches = _launches(F32_TRAIN_KERNELS)
        check(all(n > 0 for n in f32_launches.values()),
              f"12a fp32 kernels: a kernel was not launched {f32_launches}")
        paths[t, "fp32 reference"] = loss_and_grads(large, t, _plain_ops)
    large_scale = {}
    for t in LORA_LARGE_TIMESTEPS:
        ref_loss, ref = paths[t, "fp32 reference"]
        err = {label: _by_group(names, paths[t, label][1], ref)
               for label in ("kernels", "plain versions", "plain attention",
                             "fp32 kernels")}
        between = {"kernels vs plain versions": _by_group(
                       names, paths[t, "kernels"][1],
                       paths[t, "plain versions"][1]),
                   "plain versions vs plain attention": _by_group(
                       names, paths[t, "plain versions"][1],
                       paths[t, "plain attention"][1])}
        losses = {label: paths[t, label][0] for label in
                  ("kernels", "plain versions", "plain attention",
                   "fp32 kernels", "fp32 reference")}
        k_loss_rel = abs(losses["kernels"] - losses["plain versions"]) / abs(
            losses["plain versions"])
        ratio = err["kernels"]["all"] / err["plain versions"]["all"]
        log(f"phase 12a LoRA gradients, adapters dominant (up ~ N(0, "
            f"{LORA_UP_STD_LARGE}^2), {where}, t={t}): losses {losses}; rel "
            f"L2 against the fp32 reference {err}; between bf16 paths "
            f"{between}; kernels' error / their plain versions' "
            f"{ratio:.3f} (tol {LORA_ERR_RATIO:g}); fp32 kernels vs the "
            f"reference {err['fp32 kernels']['all']:.3e} (tol "
            f"{TRAIN_GRAD_REL_L2_TOL:g})")
        check(k_loss_rel <= TRAIN_LOSS_REL_TOL,
              f"12a large-scale loss, t={t}: {k_loss_rel}")
        check(ratio <= LORA_ERR_RATIO,
              f"12a large-scale bf16 kernels' gradient error, t={t}: "
              f"{ratio} of their plain versions'")
        check(err["fp32 kernels"]["all"] <= TRAIN_GRAD_REL_L2_TOL,
              f"12a large-scale fp32 kernels, t={t}: "
              f"{err['fp32 kernels']['all']}")
        large_scale[t] = dict(losses=losses, vs_fp32=err, between=between,
                              ratio=ratio)
    del paths
    return dict(merge_vs_branch=rel_mb, trained=trained,
                large=large_scale)


def _lora_export_checks(trainer, final: Path) -> dict:
    """The final checkpoint's adapter is the trained EMA tree and its
    UNet the merged weights, each tensor read back ``torch.equal``."""
    from sdxl_training_improvements_tpu_torch.models import weights as W
    from sdxl_training_improvements_tpu_torch.training import checkpoints
    tree = {k: v.detach().cpu() for k, v in trainer.eval_params().items()}
    got = checkpoints.import_lora(final / checkpoints.LORA_FILE,
                                  trainer.model.unet)
    differ = [k for k in tree if not torch.equal(got.get(k), tree[k])]
    check(set(got) == set(tree) and not differ,
          f"12a adapter differs from the EMA tree: {differ[:3]}")
    merged = trainer.unet_export_state()
    saved = W.read_safetensors(final / checkpoints.UNET_FILE)
    unet_differ = [k for k, v in merged.items()
                   if not torch.equal(saved[k], v.detach().cpu())]
    check(set(saved) == set(merged) and not unet_differ,
          f"12a merged UNet export differs: {unet_differ[:3]}")
    n_merged = sum(1 for k in tree if k.endswith(".down"))
    log(f"phase 12a final checkpoint: {checkpoints.LORA_FILE} "
        f"({(final / checkpoints.LORA_FILE).stat().st_size / 2 ** 20:.2f} "
        f"MiB, {len(tree)} tensors) read back torch.equal to the EMA tree; "
        f"the merged UNet ({len(saved)} tensors, {n_merged} merged) read "
        f"back torch.equal")
    return dict(adapter_tensors=len(tree), unet_tensors=len(saved))


def phase_lora_ema() -> dict:
    """12a: ``main.main`` with LoRA and EMA at full SDXL-base width, as
    phase 11 runs it: run A (LORA_EPOCHS epochs; steps LORA_PROFILED
    profiled), the LoRA checks on its model, run B (1 epoch with the
    final checkpoint, whose adapter and merged UNet are read back, then
    ``--resume`` to LORA_EPOCHS), ``torch.equal`` to run A."""
    import shutil
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_lora_"))
    try:
        _entry_images(root / "images", first_bucket=True)
        log(f"phase 12a: {NOVELAI_YAML.name} with phase 11's cuts and "
            f"training.lora.enabled true (rank 4, alpha 1, dropout 0, the "
            f"default targets), training.ema_decay {LORA_EMA_DECAY}; "
            f"num_epochs {LORA_EPOCHS} (run A), 1 then {LORA_EPOCHS} "
            f"(run B); phase 11's four 1024x1024 images")
        cfg_a = _lora_config(root, "lora_a", num_epochs=LORA_EPOCHS,
                             save_final_model=False)
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, steps, windows = _run_main(
            ["--config", str(cfg_a), "--output-dir", str(root / "out_a"),
             "--device", DEVICE], profiled=LORA_PROFILED, events=True)
        wall_s = time.perf_counter() - t0
        launches = _launches(LORA_KERNELS)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        n_lora = sum(v.numel() for v in trainer.state.params.values())
        for i, s in enumerate(steps):
            log(f"phase 12a run A step {i + 1}: latents {s['shape']}, loss "
                f"{s['loss']:.6f}; forward+backward {s['fwd_bwd_ms']:.2f}, "
                f"clip {s['clip_ms']:.3f}, optimizer {s['opt_ms']:.3f} ms "
                f"(CUDA events)")
        n_steps = LORA_EPOCHS
        check(len(steps) == n_steps and trainer.state.step == n_steps,
              f"12a run A: {len(steps)} steps")
        check(all(np.isfinite(s["loss"]) for s in steps),
              "12a: a loss is not finite")
        n_prof = LORA_PROFILED[1] - LORA_PROFILED[0] + 1
        idle = _log_profile(windows["prof"], "phase 12a run A steps "
                            f"{LORA_PROFILED[0]}-{LORA_PROFILED[1]}",
                            windows["profiled"])
        busy_ms = (1 - idle) * windows["profiled"] / n_prof
        prof_steps = steps[LORA_PROFILED[0] - 1:LORA_PROFILED[1]]
        opt_ms = statistics.mean(s["opt_ms"] for s in prof_steps)
        log(f"phase 12a run A: main.main {wall_s:.2f} s; "
            f"{len(trainer.state.params)} "
            f"LoRA tensors, {n_lora} parameters (fp32; the base frozen); "
            f"steps {LORA_PROFILED[0]}-{LORA_PROFILED[1]}: "
            f"{windows['profiled'] / n_prof:.2f} ms a step wall, "
            f"{busy_ms:.2f} ms of device time, idle {idle:.3f}, optimizer "
            f"+ EMA {opt_ms:.3f} ms a step (events); peak {peak_gb:.2f} "
            f"GiB; launches {launches}")
        for k, n in launches.items():
            check(n > 0, f"kernel {k} was not launched on the LoRA path")
        check(launches["probe"] > 0, "12a: no startup probe")
        ref, ref_meta = _state_snapshot(trainer.state)
        batch = _entry_cached_batch(trainer, _entry_name(0))
        parity = _lora_checks(trainer, batch)
        del trainer, batch
        _free()

        cfg_b1 = _lora_config(root, "lora_b1", num_epochs=1,
                              save_final_model=True)
        trainer, steps_b1, _ = _run_main(
            ["--config", str(cfg_b1), "--output-dir", str(root / "out_b"),
             "--device", DEVICE])
        save = dict(trainer.last_save)
        final = root / "out_b" / "final_checkpoint"
        export = _lora_export_checks(trainer, final)
        del trainer
        _free()
        cfg_b2 = _lora_config(root, "lora_b2", num_epochs=LORA_EPOCHS,
                              save_final_model=False)
        trainer, steps_b2, _ = _run_main(
            ["--config", str(cfg_b2), "--output-dir", str(root / "out_b"),
             "--resume", "--device", DEVICE])
        got, meta = _state_snapshot(trainer.state)
        del trainer
        _free()
        differ = [k for k in ref if not torch.equal(ref[k], got[k])]
        log(f"phase 12a run B: checkpoint train state "
            f"{save['state_gib']:.4f} GiB, export {save['export_gib']:.2f} "
            f"GiB; resumed, {len(ref)} tensors (LoRA tree, EMA shadow, "
            f"moments), {len(differ)} differ {differ[:3]}; generators and "
            f"step equal {meta == ref_meta}; losses "
            f"{[round(s['loss'], 6) for s in steps_b1 + steps_b2]} vs run A "
            f"{[round(s['loss'], 6) for s in steps]}")
        check(set(got) == set(ref) and not differ,
              f"12a resume: tensors differ {differ[:3]}")
        check(meta == ref_meta, "12a resume: step or generators differ")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not root.exists(), f"{root} was not deleted")
    log(f"phase 12a wall time {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, steps=steps, idle=idle, busy_ms=busy_ms,
                opt_ms=opt_ms, peak_gb=peak_gb, parity=parity, save=save,
                export=export)


def _state_gib(state) -> float:
    """GiB of the optimizer state's tensors."""
    from sdxl_training_improvements_tpu_torch.training import checkpoints
    tensors, _ = checkpoints.flatten_train_state(state)
    return sum(t.numel() * t.element_size() for k, t in tensors.items()
               if k.startswith("opt.")) / 2 ** 30


def _optimizer_path(label: str, model, cfg, batch, n_steps: int,
                    init: dict, kernels=OPT_KERNELS) -> tuple:
    """``n_steps`` of ``cfg``'s optimizer through make_optimizer ->
    make_train_step -> create_train_state on the seeded weights ``init``;
    the last step profiled.  Returns (a row of numbers, the state)."""
    from torch.profiler import ProfilerActivity, profile

    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        create_train_state, make_train_step)
    model.unet.load_state_dict(init)
    _zero_launches()
    _free()
    optimizer = make_optimizer(cfg)
    step = make_train_step(model.unet_apply, NoiseSchedule.from_config(cfg),
                           optimizer, cfg)
    state = create_train_state(model.trainable_params(), optimizer,
                               seed=cfg.training.seed)
    torch.cuda.synchronize()
    state_gib = _state_gib(state)
    rows = []
    for i in range(n_steps):
        ev: dict = {}
        with ExitStack() as stack:
            if i == n_steps - 1:
                prof = stack.enter_context(
                    profile(activities=[ProfilerActivity.CUDA]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, ev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        row = dict(loss=metrics["loss"].item(), wall_ms=wall_ms,
                   **_event_ms(ev))
        rows.append(row)
        log(f"phase {label} step {i + 1}: loss {row['loss']:.6f}, grad norm "
            f"{metrics['grad_norm'].item():.6f}; {wall_ms:.2f} ms wall = "
            f"forward+backward {row['fwd_bwd_ms']:.2f} + clip "
            f"{row['clip_ms']:.2f} + optimizer {row['opt_ms']:.2f} ms")
        check(np.isfinite(row["loss"]), f"{label} step {i + 1} loss")
    idle = _log_profile(prof, f"phase {label} step {n_steps}",
                        rows[-1]["wall_ms"])
    launches = _launches(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase {label}: {type(optimizer).__name__}, optimizer state "
        f"{state_gib:.2f} GiB, peak {peak_gb:.2f} GiB, last step device "
        f"{(1 - idle) * rows[-1]['wall_ms']:.2f} ms, idle {idle:.3f}; "
        f"launches {launches}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched in phase {label}")
    retries = getattr(optimizer, "eigh_retries", None)
    if retries is not None:
        log(f"phase {label}: {retries} eigh calls solved again in fp64 "
            "after fp32 did not converge")
    return dict(steps=rows, idle=idle, launches=launches, peak_gb=peak_gb,
                state_gib=state_gib, eigh_retries=retries), state


def _soap_reckoning(cfg) -> dict:
    """GiB of SOAP's state at full width for ``cfg``, from the UNet's
    shapes (meta tensors)."""
    from sdxl_training_improvements_tpu_torch.models.unet import (
        SDXLUNet, UNetConfig)
    from sdxl_training_improvements_tpu_torch.training.optimizers.soap import (
        SOAP, _precond_shape)
    oc = cfg.optimizer
    soap = SOAP(max_precond_dim=oc.max_precond_dim, merge_dims=oc.merge_dims)
    with torch.device("meta"):
        shapes = [p.shape for p in SDXLUNet(UNetConfig.sdxl()).parameters()]
    n = sum(math.prod(s) for s in shapes)
    mats = sum(d * d for s in shapes for d in _precond_shape(
        soap.leaf_shape(s), oc.max_precond_dim, oc.precondition_1d))
    return dict(moments=2 * n * 4 / 2 ** 30, gg_q=2 * mats * 4 / 2 ** 30,
                grads=n * (2 if cfg.tpu.grad_accum_dtype == "bfloat16"
                           else 4) / 2 ** 30)


def _int8_leaf_case(gen) -> dict:
    """One INT8_LEAF update: dequantize -> the CUDA kernel -> quantize
    against dequantize -> the plain chain -> quantize, ``torch.equal`` in
    the delta, the shift, the codes and the scales; and the times."""
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O
    from sdxl_training_improvements_tpu_torch.ops import quantize as Q

    def randn(scale):
        return scale * torch.randn(INT8_LEAF, generator=gen, device=DEVICE)

    p, g = randn(0.05).bfloat16(), randn(1e-3)
    mq = Q.quantize_8bit(randn(1e-4), signed=True)
    vq = Q.quantize_8bit(randn(1e-4).square(), signed=False)
    shift = randn(1e-7).bfloat16()
    kw = dict(lr_eff=1e-4 * (1 - 0.999 ** 3) ** 0.5, decay_amt=0.0,
              seed0=0x9E3779B9, seed1=0x7F4A7C15)

    def update(fn, sh):
        m = Q.dequantize_8bit(mq, signed=True)
        v = Q.dequantize_8bit(vq, signed=False)
        delta, m, v, sh = fn(p, g, m, v, sh, **kw)
        return (delta, sh, Q.quantize_8bit(m, signed=True),
                Q.quantize_8bit(v, signed=False))

    got = update(O.fused_adamw_cuda, shift.clone())
    ref = update(O.fused_adamw_reference, shift)
    equal = {"delta": torch.equal(got[0], ref[0]),
             "shift": torch.equal(got[1], ref[1]),
             **{f"{name}.{k}": torch.equal(a[k], b[k])
                for name, a, b in (("m", got[2], ref[2]),
                                   ("v", got[3], ref[3]))
                for k in ("q", "s")}}
    res = dict(equal=all(equal.values()),
               ms=time_ms(lambda: update(O.fused_adamw_cuda, shift.clone())),
               plain_ms=time_ms(lambda: update(O.fused_adamw_reference,
                                               shift),
                                warmup=1, iters=3, repeats=3))
    log(f"phase 12d int8 leaf {list(INT8_LEAF)}: dequantize -> CUDA fused "
        f"AdamW -> quantize vs dequantize -> plain chain -> quantize: "
        f"torch.equal {equal}; {res['ms']:.4f} ms vs {res['plain_ms']:.4f} "
        f"ms a leaf")
    check(res["equal"], f"12d int8 leaf not equal to plain: {equal}")
    return res


def _int8_bytes_per_param(state) -> float:
    """Optimizer-state bytes per bf16 parameter (moments and shift)."""
    st = state.opt_state
    n = nbytes = 0
    for k, p in state.params.items():
        if p.dtype != torch.bfloat16:
            continue
        n += p.numel()
        for moment in (st.exp_avg[k], st.exp_avg_sq[k]):
            ts = moment.values() if isinstance(moment, dict) else [moment]
            nbytes += sum(t.numel() * t.element_size() for t in ts)
        nbytes += st.shift[k].numel() * st.shift[k].element_size()
    return nbytes / n


def phase_optimizers() -> dict:
    """12b-12e on one seeded full-width model, its UNet reset to the same
    weights before each: schedule-free (``eval_params`` is x), SOAP (the
    install, an Adam step and a QR refresh; the cuts SOAP_CUTS),
    adamw_bf16 with int8 moments (4 state bytes a parameter; one leaf
    through the kernel against plain) and adamw_bf16 with an EMA shadow
    of the whole UNet."""
    from sdxl_training_improvements_tpu_torch import _yaml
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        schedule_free_eval_params)
    t_phase = time.perf_counter()
    raw = _yaml.load_file(NOVELAI_YAML)
    raw["model"]["pretrained_model_name"] = str(Path(tempfile.gettempdir())
                                                / "no-checkpoint")
    raw["training"]["gradient_accumulation_steps"] = 1
    log("phase 12b-12e: the recipe of "
        f"{NOVELAI_YAML.name} through make_optimizer -> make_train_step -> "
        "create_train_state (bf16, v-prediction, micro-batch 1, no remat), "
        "global batch 4 at 1024^2 as 4 micro-steps of 1 "
        "(gradient_accumulation_steps 4 -> 1, as phase 11), seeded weights "
        "and latents")
    cfg, model = _model_from_config(raw)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    batch = _train_batch(model, cfg.training.batch_size, gen, SIZE)
    init = {k: v.detach().cpu() for k, v in model.unet.state_dict().items()}
    out = {}

    cfg.optimizer.optimizer_type = "adamw_schedule_free_kahan"
    cfg.optimizer.warmup_steps = SF_WARMUP
    log(f"phase 12b: optimizer_type adamw_schedule_free_kahan, warmup_steps "
        f"{SF_WARMUP}, kahan_sum {cfg.optimizer.kahan_sum}, {SF_STEPS} steps")
    out["sf"], state = _optimizer_path("12b", model, cfg, batch, SF_STEPS,
                                       init)
    x = schedule_free_eval_params(state.opt_state, state.params,
                                  beta1=cfg.optimizer.beta1)
    name = WATCHED[0]
    z, y = state.opt_state.z[name], state.params[name]
    want = ((y.float() - (1 - cfg.optimizer.beta1) * z)
            / cfg.optimizer.beta1).to(y.dtype)
    check(torch.equal(x[name], want), "12b eval_params is not the x "
          "sequence")
    log(f"phase 12b eval_params: x = (y - (1 - b1) z) / b1 on {name}, "
        f"differing from y in {int((x[name] != y).sum())} of {y.numel()}")
    del state, x
    _free()

    cfg.optimizer.optimizer_type = "soap"
    cfg.optimizer.precondition_frequency = SOAP_STEPS
    need = _soap_reckoning(cfg)
    # what phase 12b's peak held beside its state: weights, activations
    # and the fp32 gradient accumulator (its three fp32 trees are 1.5 x
    # SOAP's two moments)
    base = out["sf"]["peak_gb"] - 1.5 * need["moments"] - need["grads"]
    cuts = []
    for cut in SOAP_CUTS + (None,):
        est = base + sum(need.values())
        log(f"phase 12c reckoning ({', '.join(cuts) or 'no cut'}): SOAP "
            f"moments {need['moments']:.2f} GiB + GG and Q "
            f"{need['gg_q']:.2f} + gradient accumulator {need['grads']:.2f} "
            f"+ weights and activations {base:.2f} = {est:.2f} GiB (room: "
            f"{SOAP_FIT_GIB} GiB)")
        if est < SOAP_FIT_GIB or cut is None:
            break
        section, key, value = cut
        setattr(getattr(cfg, section), key, value)
        cuts.append(f"{section}.{key} -> {value}")
        need = _soap_reckoning(cfg)
    log(f"phase 12c: optimizer_type soap, precondition_frequency "
        f"{SOAP_STEPS}, merge_dims {cfg.optimizer.merge_dims}, "
        f"max_precond_dim {cfg.optimizer.max_precond_dim}; cuts: "
        f"{cuts or 'none'}; {SOAP_STEPS} steps (install, then Adam + QR "
        f"refresh)")
    out["soap"], state = _optimizer_path("12c", model, cfg, batch,
                                         SOAP_STEPS, init)
    out["soap"]["cuts"] = cuts
    out["soap"]["first_step_s"] = out["soap"]["steps"][0]["wall_ms"] / 1e3
    log(f"phase 12c: the install step took "
        f"{out['soap']['first_step_s']:.2f} s wall (eigh of every GG)")
    del state
    _free()
    cfg.optimizer.max_precond_dim = 10000
    cfg.tpu.grad_accum_dtype = "float32"

    cfg.optimizer.optimizer_type = "adamw_bf16"
    cfg.optimizer.moments_8bit = True
    log(f"phase 12d: adamw_bf16, moments_8bit true, sr_noise "
        f"{cfg.tpu.sr_noise}, {INT8_STEPS} steps")
    out["int8"], state = _optimizer_path(
        "12d", model, cfg, batch, INT8_STEPS, init,
        kernels=OPT_KERNELS + ("fused_adamw",))
    per_param = _int8_bytes_per_param(state)
    log(f"phase 12d: {per_param:.4f} optimizer-state bytes a bf16 "
        f"parameter (bf16 moments: 6)")
    check(abs(per_param - 4.0) < 1e-3, f"12d: {per_param} bytes a param")
    out["int8"]["bytes_per_param"] = per_param
    del state
    _free()
    cfg.optimizer.moments_8bit = False

    cfg.training.ema_decay = LORA_EMA_DECAY
    log(f"phase 12e: adamw_bf16 (bf16 moments), training.ema_decay "
        f"{LORA_EMA_DECAY}: the full fine-tune with its fp32 shadow, "
        f"{EMA_STEPS} steps")
    out["ema"], state = _optimizer_path(
        "12e", model, cfg, batch, EMA_STEPS, init,
        kernels=OPT_KERNELS + ("fused_adamw",))
    shadow = state.opt_state.ema
    shadow_gib = sum(t.numel() * t.element_size()
                     for t in shadow.values()) / 2 ** 30
    log(f"phase 12e: EMA shadow {shadow_gib:.2f} GiB of the optimizer "
        f"state's {out['ema']['state_gib']:.2f}")
    out["ema"]["shadow_gib"] = shadow_gib
    del state, shadow
    _free()
    cfg.training.ema_decay = None
    out["int8"]["leaf"] = _int8_leaf_case(gen)
    del model, init, batch
    _free()
    out["resume"] = _tiny_resumes()
    log(f"phase 12b-12e wall time {time.perf_counter() - t_phase:.1f} s")
    return out


def _tiny_config(root: Path, name: str, images: Path, optimizer: dict,
                 **training) -> Path:
    from sdxl_training_improvements_tpu_torch import _yaml
    raw = {"model": {"model_type": "sdxl_tiny",
                     "pretrained_model_name": str(root / "none")},
           "optimizer": {"learning_rate": 1e-4, **optimizer},
           "training": {"batch_size": 2, "save_every": 0,
                        "save_best": False, **training},
           "tpu": {"sr_noise": "hash"},
           "data": {"train_data_dir": [str(images)], "image_size": 64},
           "global_config": {
               "cache": {"cache_dir": str(root / "cache")},
               "image": TINY_IMAGE,
               "logging": {"log_dir": str(root / "logs")}}}
    path = root / f"{name}.yaml"
    path.write_text(_yaml.dump(raw))
    return path


def _tiny_resumes() -> dict:
    """Each new optimizer state through a checkpoint on the card:
    ``main.main`` on the tiny model over 4 seeded 64x64 PNGs, 2 epochs
    uninterrupted against 1 epoch with the final checkpoint then
    ``--resume``, every tensor and generator ``torch.equal``."""
    import shutil
    cases = {"schedule_free": ({"optimizer_type":
                                "adamw_schedule_free_kahan",
                                "warmup_steps": 2}, "no"),
             "soap": ({"optimizer_type": "soap",
                       "precondition_frequency": 2}, "no"),
             "int8": ({"optimizer_type": "adamw_bf16", "moments_8bit": True},
                      "bf16")}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    res = {}
    try:
        images = root / "images"
        images.mkdir()
        rng = np.random.default_rng(SEED)
        for i in range(4):
            _write_paeth_png(images / f"{i}.png", rng.integers(
                0, 256, (64, 64, 3), dtype=np.uint8))
            (images / f"{i}.txt").write_text(ENTRY_CAPTIONS[i])
        for label, (opt, precision) in cases.items():
            d = root / label
            d.mkdir()
            kw = dict(mixed_precision=precision)

            def run(name, epochs, *extra, **more):
                cfg = _tiny_config(d, name, images, opt, num_epochs=epochs,
                                   **kw, **more)
                return _run_main(["--config", str(cfg), "--output-dir",
                                  str(d / ("a" if name == "a" else "b")),
                                  "--device", DEVICE, *extra])[0]

            ref = _state_snapshot(run("a", 2, save_final_model=False).state)
            run("b1", 1)
            got = _state_snapshot(run("b2", 2, "--resume",
                                      save_final_model=False).state)
            differ = [k for k in ref[0] if not torch.equal(ref[0][k],
                                                           got[0].get(k))]
            log(f"phase 12 resume on the card, tiny model, {label} "
                f"({precision}): {len(ref[0])} tensors, {len(differ)} "
                f"differ {differ[:3]}; step and generators equal "
                f"{got[1] == ref[1]}")
            check(set(got[0]) == set(ref[0]) and not differ,
                  f"{label} resume: tensors differ {differ[:3]}")
            check(got[1] == ref[1], f"{label} resume: step or generators")
            res[label] = len(ref[0])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


# ------- phase 14: remat policies, optimizer layouts, host-streamed state
LAYOUT_STEPS = 2  # the same at each optimizer layout
# 14a's policies that also take a profiled train step (every policy takes
# the gradient check): the default ("dots" too until the script outgrew
# its time limit), its top kernels listed as profile_step lists them
PROFILED_14A = ("full",)
TOP_14A = 10
# (layout, noise) of 14b: the default, its rbg twin and the three packings
LAYOUTS_14B = (("per_leaf", "hash"), ("per_leaf", "rbg"), ("flat", "hash"),
               ("hybrid", "hash"), ("stacked", "hash"))
V5E16_YAML = Path(__file__).resolve().parent / "configs" / \
    "v5e16_single_chip.yaml"
# 14c run A: 2 steps over phase 11's first bucket (4 over both buckets
# until the script outgrew its time limit)
HOST_EPOCHS = 2
HOST_KERNELS = TRAIN_KERNELS + ("gn_silu_fwd_f32", "probe")
RBG_CHUNK = 1 << 25  # elements of a flat group's plain chain at a time
STACK_CHECK_MAX = 1 << 26  # elements of the stack held against plain


def _set_policy(model, name: str) -> None:
    """Put the UNet under remat policy ``name`` (its config and its
    policies), as ``UNetConfig(remat_policy=name)`` would build it."""
    import dataclasses

    from sdxl_training_improvements_tpu_torch.models import unet as U
    model.unet.config = dataclasses.replace(model.unet.config,
                                            remat_policy=name)
    model.unet.remat_policies = U.remat_policies(name)


def _policy_grads(model, cfg, batch, schedule, params) -> tuple:
    """One forward and backward under the UNet's current policy, with
    cuDNN's deterministic algorithms: (loss, gradients, GiB of the
    outputs the policy kept in the forward)."""
    from sdxl_training_improvements_tpu_torch.models import unet as U
    from sdxl_training_improvements_tpu_torch.training import loop
    from sdxl_training_improvements_tpu_torch.training.methods import (
        get_method)
    policies = model.unet.remat_policies
    kept = {"bytes": 0, "forward": True}

    def counted(policy):
        if policy is None:
            return None

        def wrapped(op, args, name):
            keep = policy(op, args, name)
            if keep and kept["forward"]:
                kept["bytes"] += U.out_elements(op, args) * \
                    args[0].element_size()
            return keep
        return wrapped

    model.unet.remat_policies = tuple(counted(p) for p in policies)
    try:
        with loop.deterministic_convolutions(torch.device(DEVICE)):
            loss, _ = get_method(cfg.training.method)(
                model.unet_apply, batch, None, schedule, cfg.model)
            kept["forward"] = False
            grads = torch.autograd.grad(loss, params)
    finally:
        model.unet.remat_policies = policies
    return loss.detach(), grads, kept["bytes"] / 2 ** 30


def phase_remat_policies(model, cfg, batch) -> dict:
    """14a: every remat policy of ``models/unet.py`` on the default
    ``Config()`` at b4 1024^2.  Per policy: one forward and backward at
    fixed noise and timesteps (cuDNN deterministic) whose gradients are
    held against "full"'s (``torch.equal``, or within phase 7's bar when
    not bit-equal, said so), the UNet kernels' launches in it, its peak
    GiB and the GiB its kept outputs take; then, on one train state after
    a warm step, one profiled train step for each of ``PROFILED_14A``
    (device ms, idle share, launches, peak GiB)."""
    from torch.profiler import ProfilerActivity, profile

    from sdxl_training_improvements_tpu_torch.models import unet as U
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        create_train_state, make_train_step)
    names = ["full"] + sorted(n for n in U.remat_policy_table()
                              if n != "full")
    schedule = NoiseSchedule.from_config(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    fixed = dict(batch)
    shape = tuple(batch["vae_latents"].shape)
    fixed["noise"] = torch.randn(shape, generator=gen, device=DEVICE)
    fixed["timesteps"] = torch.tensor([100, 400, 700, 900][:shape[0]],
                                      device=DEVICE)
    params = list(model.unet.parameters())
    unet_kernels = [k for k in TRAIN_KERNELS if k != "fused_adamw"]
    rows, ref = {}, None
    for name in names:
        _set_policy(model, name)
        _free()
        before = _launches(unet_kernels)
        loss, grads, kept_gib = _policy_grads(model, cfg, fixed, schedule,
                                              params)
        torch.cuda.synchronize()
        after = _launches(unet_kernels)
        for k in unet_kernels:
            check(after[k] > before[k], f"14a {name}: {k} not launched")
        row = dict(loss=loss.item(), kept_gib=kept_gib,
                   grad_peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        if ref is None:
            ref = (loss, grads)
            row.update(equal=True, rel_l2=0.0)
        else:
            row["equal"] = bool(torch.equal(loss, ref[0])) and all(
                torch.equal(a, b) for a, b in zip(grads, ref[1]))
            num = sum((a.float() - b.float()).square().sum()
                      for a, b in zip(grads, ref[1]))
            den = sum(b.float().square().sum() for b in ref[1])
            row["rel_l2"] = (num / den).sqrt().item()
        del grads
        rows[name] = row
        log(f"phase 14a {name}: loss {row['loss']:.6f}; gradients "
            f"{'torch.equal to' if row['equal'] else 'NOT bit-equal to'} "
            f"\"full\"'s (rel L2 {row['rel_l2']:.3e}); kept outputs "
            f"{kept_gib:.3f} GiB; forward+backward peak "
            f"{row['grad_peak_gb']:.2f} GiB")
        check(row["equal"] or row["rel_l2"] <= TRAIN_GRAD_REL_L2_TOL,
              f"14a {name}: gradients rel L2 {row['rel_l2']}")
    del ref
    _set_policy(model, "full")
    _free()
    optimizer = make_optimizer(cfg)
    step = make_train_step(model.unet_apply, schedule, optimizer, cfg)
    state = create_train_state(model.trainable_params(), optimizer,
                               seed=cfg.training.seed)
    _zero_launches()
    state, _ = step(state, batch)  # warm: the state's first step
    for name in PROFILED_14A:
        _set_policy(model, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _launches(TRAIN_KERNELS)
        ev: dict = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, ev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        after = _launches(TRAIN_KERNELS)
        check(np.isfinite(metrics["loss"].item()), f"14a {name} step loss")
        idle = _log_profile(prof, f"phase 14a {name} step", wall_ms,
                            top=TOP_14A)
        row = rows[name]
        row.update(wall_ms=wall_ms, idle=idle,
                   device_ms=(1 - idle) * wall_ms,
                   peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches={k: after[k] - before[k]
                             for k in TRAIN_KERNELS},
                   **_event_ms(ev))
        log(f"phase 14a {name}: step wall {wall_ms:.2f} ms, device "
            f"{row['device_ms']:.2f} ms (idle {idle:.3f}); forward+backward "
            f"{row['fwd_bwd_ms']:.2f} ms (events); peak {row['peak_gb']:.2f}"
            f" GiB; launches {row['launches']}")
        for k in TRAIN_KERNELS:
            check(row["launches"][k] > 0, f"14a {name}: {k} not launched")
    launches = _launches(TRAIN_KERNELS)
    _set_policy(model, "full")
    del state, step, optimizer
    _free()
    log("phase 14a table (policy: device ms a step | peak GiB | kept GiB | "
        "gradients vs full): " + "; ".join(
            (f"{n}: {r['device_ms']:.1f} | {r['peak_gb']:.2f} | "
             if "device_ms" in r else f"{n}: not profiled | - | ")
            + f"{r['kept_gib']:.2f} | "
            f"{'equal' if r['equal'] else 'rel %.2e' % r['rel_l2']}"
            for n, r in rows.items()) + ".  Under the flash kernel no "
        "policy keeps S^2 logits: the attention is one operator, as JAX's "
        "Pallas flash path keeps none")
    return dict(rows=rows, launches=launches)


def _adamw_bf16_of(cfg, layout: str, noise: str):
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        AdamWBF16)
    oc = cfg.optimizer
    return AdamWBF16(lr=oc.learning_rate, betas=(oc.beta1, oc.beta2),
                     eps=oc.epsilon, weight_decay=oc.weight_decay,
                     layout=layout, noise=noise)


def phase_layouts(model, cfg, batch) -> dict:
    """14b: each (layout, noise) of LAYOUTS_14B through make_train_step ->
    create_train_state at b4 1024^2, LAYOUT_STEPS steps: the optimizer's
    ms (CUDA events), kernel #7's launches a step by variant, the state's
    and the peak GiB.  Returns the rows and the partitions' sizes for the
    kernel checks."""
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        create_train_state, make_train_step)
    schedule = NoiseSchedule.from_config(cfg)
    rows = {}
    _zero_launches()
    for layout, noise in LAYOUTS_14B:
        label = f"{layout}/{noise}"
        _free()
        opt = _adamw_bf16_of(cfg, layout, noise)
        step = make_train_step(model.unet_apply, schedule, opt, cfg)
        state = create_train_state(model.trainable_params(), opt,
                                   seed=cfg.training.seed)
        torch.cuda.synchronize()
        state_gib = _state_gib(state)
        for i in range(LAYOUT_STEPS):
            before = dict(O.fused_adamw_cuda.launches_by_noise)
            ev: dict = {}
            state, metrics = step(state, batch, ev)
            torch.cuda.synchronize()
            after = dict(O.fused_adamw_cuda.launches_by_noise)
            check(np.isfinite(metrics["loss"].item()),
                  f"14b {label} step {i + 1} loss")
        per_step = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        row = dict(state_gib=state_gib, launches=per_step,
                   peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                   units=len(opt.groups(state.params)), **_event_ms(ev))
        rows[label] = row
        log(f"phase 14b {label}: optimizer {row['opt_ms']:.2f} ms (CUDA "
            f"events, step {LAYOUT_STEPS}); #7 launches a step {per_step}; "
            f"state {state_gib:.2f} GiB; peak {row['peak_gb']:.2f} GiB; "
            f"groups {row['units']}")
        check(sum(per_step.values()) > 0, f"14b {label}: #7 not launched")
        check(per_step.get(noise, 0) > 0, f"14b {label}: no {noise} launch")
        if layout == "flat":
            sizes = [sum(state.params[n].numel() for n in names)
                     for names in opt.groups(state.params).values()]
        if layout == "stacked":
            stacks = [(len(names), state.params[names[0]].numel())
                      for names in opt.groups(state.params).values()]
        del state, step, opt
    launches = _launches(("fused_adamw", "fused_adamw_rbg"))
    _free()
    return dict(rows=rows, launches=launches, flat_sizes=sizes,
                stacks=stacks)


def _adamw_rbg_case(shape, gen, flat_g: bool = False) -> dict:
    """Kernel #7's rbg variant against its plain version on one tensor of
    ``shape`` (``flat_g``: a flat group's bf16 gradient), planes drawn on
    the card: ``torch.equal`` in every output; times and bound at
    [10240, 1280]."""
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O

    def randn(scale):
        return scale * torch.randn(shape, generator=gen, device=DEVICE)

    p = randn(0.05).bfloat16()
    g = randn(1e-3).to(torch.bfloat16 if flat_g else torch.float32)
    m = randn(1e-4).bfloat16()
    v = (1e-8 * randn(1.0).square()).bfloat16()
    shift = randn(1e-7).bfloat16()
    planes = O.draw_planes(p.numel(), gen)
    kw = dict(lr_eff=1e-4 * (1 - 0.999 ** 3) ** 0.5, decay_amt=5.02e-3,
              seed0=0, seed1=0, planes=planes)
    if flat_g:  # the plain chain in chunks: exact, as the noise is drawn
        parts = [O.fused_adamw_reference(
            *(x[s:s + RBG_CHUNK] for x in (p, g, m, v, shift)),
            **dict(kw, planes=planes[:, s:s + RBG_CHUNK]))
            for s in range(0, p.numel(), RBG_CHUNK)]
        ref = tuple(torch.cat(xs) for xs in zip(*parts))
        del parts
    else:
        ref = O.fused_adamw_reference(p, g, m, v, shift, **kw)
    got = O.fused_adamw_cuda(p, g, m.clone(), v.clone(), shift.clone(),
                             **kw)
    equal = {name: torch.equal(a, r) for name, a, r in
             zip(("delta", "m", "v", "shift"), got, ref)}
    err = max((a.float() - r.float()).abs().max().item()
              for a, r in zip(got, ref))
    del ref, got
    res = dict(err=err, equal=all(equal.values()), shape=list(shape))
    if not flat_g:
        state = [m.clone(), v.clone(), shift.clone()]
        res.update(
            ms=time_ms(lambda: O.fused_adamw_cuda(p, g, *state, **kw)),
            dev=device_ms(lambda: O.fused_adamw_cuda(p, g, *state, **kw)),
            plain_ms=time_ms(lambda: O.fused_adamw_reference(
                p, g, m, v, shift, **kw), warmup=1, iters=3, repeats=3))
        n = p.numel()
        # p, m, v, shift, g and the two planes read; delta, m, v, shift
        res["bound"] = bound(OPS_PER_ELEMENT["fused_adamw"] * n,
                             (16 + 4 + 8) * n, PEAK_FP32)
        log(f"phase 14b rbg variant {list(shape)}: kernel {res['ms']:.4f} "
            f"ms (device {fmt_ms(res['dev'])}), plain {res['plain_ms']:.4f}"
            f" ms, bound {res['bound'][0]:.4f} ms ({res['bound'][1]})")
    log(f"phase 14b rbg variant {list(shape)}{' (a flat group)' if flat_g else ''}"
        f": torch.equal to plain {equal}, max_abs_err {err:.3e}")
    check(res["equal"], f"14b rbg {list(shape)}: not equal to plain {equal}")
    return res


def _stack_decay_case(k: int, n: int, gen) -> dict:
    """The stacked layout's launch (#7 with one decay amount per row)
    against its plain version: ``torch.equal``."""
    from sdxl_training_improvements_tpu_torch.ops import fused_adamw as O

    def randn(scale):
        return scale * torch.randn((k, n), generator=gen, device=DEVICE)

    p, g, m = randn(0.05).bfloat16(), randn(1e-3).bfloat16(), \
        randn(1e-4).bfloat16()
    v, shift = (1e-8 * randn(1.0).square()).bfloat16(), \
        randn(1e-7).bfloat16()
    decay = torch.where(torch.arange(k, device=DEVICE) % 2 == 0,
                        torch.tensor(5.02e-3, device=DEVICE),
                        torch.tensor(0.0, device=DEVICE)).float()
    kw = dict(lr_eff=1e-4, decay_amt=0.0, seed0=11, seed1=12, decay=decay)
    ref = O.fused_adamw_reference(p, g, m, v, shift, **kw)
    got = O.fused_adamw_cuda(p, g, m.clone(), v.clone(), shift.clone(),
                             **kw)
    equal = all(torch.equal(a, r) for a, r in zip(got, ref))
    log(f"phase 14b stacked launch [{k}, {n}] (decay on every other row): "
        f"torch.equal to plain {equal}")
    check(equal, f"14b stacked [{k}, {n}]: not equal to plain")
    return dict(shape=[k, n], equal=equal)


def _host_entry_config(root: Path, name: str, **training) -> Path:
    """``configs/v5e16_single_chip.yaml`` as the port's reader loads it,
    with phase 11's cuts (logged by the caller), written to ``root``."""
    from sdxl_training_improvements_tpu_torch import _yaml
    raw = _yaml.load_file(V5E16_YAML)
    raw["model"]["pretrained_model_name"] = str(root / "no-checkpoint")
    raw["training"].update(gradient_accumulation_steps=1, **training)
    raw["data"]["train_data_dir"] = [str(root / "images")]
    raw["global_config"] = {"cache": {"cache_dir": str(root / "cache")},
                            "logging": {"log_dir": str(root / "logs")}}
    path = root / f"{name}.yaml"
    path.write_text(_yaml.dump(raw))
    return path


def _resident_bytes(opt_state) -> tuple:
    """(GiB of the optimizer state on the card, GiB on the host)."""
    from sdxl_training_improvements_tpu_torch.training import checkpoints
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        TrainState)
    tensors, _ = checkpoints.flatten_train_state(TrainState(
        step=0, params={}, opt_state=opt_state,
        generator=torch.Generator()))
    on = {"cuda": 0, "cpu": 0}
    for t in tensors.values():
        on[t.device.type] += t.numel() * t.element_size()
    return on["cuda"] / 2 ** 30, on["cpu"] / 2 ** 30


def _copy_overlap(trainer) -> dict:
    """On run A's final state: the streamed update (X), the copies alone
    through the same pipeline (C) and the same update with the state
    resident on the card (K), each the second of two calls between two
    synchronizes; the share of the copy time hidden = (K + C - X) / C."""
    import dataclasses

    from sdxl_training_improvements_tpu_torch.core import offload
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        AdamWBF16)
    opt, state = trainer.optimizer, trainer.state
    params = state.params
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    grads = {k: torch.empty_like(p).normal_(0.0, 1e-3, generator=gen)
             for k, p in params.items()}  # with the parameters' strides

    def timed(fn):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    streamed = timed(lambda: opt.update(grads, state.opt_state, params))
    host = _host_tensors(state.opt_state)
    groups, cur, n = [], [], 0
    for t in host:
        cur.append(t)
        n += t.numel()
        if n >= opt.stream_group_params:
            groups.append(cur)
            cur, n = [], 0
    if cur:
        groups.append(cur)

    def store(group, outputs):
        for h, d in zip(group, outputs):
            h.copy_(d, non_blocking=True)
    copies = timed(lambda: offload.stream_groups(
        groups, lambda g: [offload.to_device(t, DEVICE) for t in g],
        lambda g, x: x, store, DEVICE))
    nbytes = sum(t.numel() * t.element_size() for t in host)
    resident_opt = AdamWBF16(lr=opt.lr, betas=(opt.beta1, opt.beta2),
                             eps=opt.eps, weight_decay=opt.weight_decay,
                             moments=opt.moments, noise=opt.noise)
    st = state.opt_state
    resident = dataclasses.replace(
        st, exp_avg=offload.fetch_to_device(st.exp_avg, DEVICE),
        exp_avg_sq=offload.fetch_to_device(st.exp_avg_sq, DEVICE),
        shift=offload.fetch_to_device(st.shift, DEVICE))
    compute = timed(lambda: resident_opt.update(grads, resident, params))
    del resident, grads
    hidden = (compute + copies - streamed) / copies
    log(f"phase 14c copy overlap: streamed update {streamed:.2f} ms; the "
        f"same update with the state resident {compute:.2f} ms; the copies "
        f"alone ({nbytes / 2 ** 30:.2f} GiB each way, "
        f"{2 * nbytes / 2 ** 30 / (copies / 1e3):.1f} GiB/s both ways) "
        f"{copies:.2f} ms; hidden share of the copy time {hidden:.3f}")
    return dict(streamed_ms=streamed, resident_ms=compute, copies_ms=copies,
                copy_gib=nbytes / 2 ** 30, hidden=hidden)


def _host_tensors(opt_state) -> list:
    """The optimizer state's tensors in host memory (the streamed ones)."""
    out = []
    for tree in (opt_state.exp_avg, opt_state.exp_avg_sq, opt_state.shift):
        for v in tree.values():
            out.extend(t for t in (v.values() if isinstance(v, dict)
                                   else [v]) if t.device.type == "cpu")
    return out


def phase_host_state() -> dict:
    """14c: ``main.main`` on ``configs/v5e16_single_chip.yaml`` (int8
    moments, shift_host and moments_host, micro-batch 1, bf16 gradient
    accumulator, no remat) at full SDXL-base width with phase 11's cuts,
    over phase 11's 8 images: run A (HOST_EPOCHS epochs: each step's
    update ms by CUDA events, the state's GiB on the card and on the host,
    peak memory, launches), the copy overlap on its final state, then run
    B (1 epoch with the final checkpoint, ``--resume`` to HOST_EPOCHS),
    ``torch.equal`` to run A."""
    import shutil
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_host_"))
    n_steps = HOST_EPOCHS
    try:
        _entry_images(root / "images", first_bucket=True)
        log(f"phase 14c: config {V5E16_YAML.name} (ddpm, v-prediction, "
            "ZTSNR, adamw_bf16 with moments_8bit, shift_host and "
            "moments_host, bf16, micro-batch 1, bf16 gradient accumulator, "
            "no remat) with phase 11's cuts: data, cache, log and output "
            "paths in a temporary directory; gradient_accumulation_steps "
            "4 -> 1 (global batch 4 as 4 micro-steps of 1; for time); "
            "model.pretrained_model_name -> a path that does not exist "
            f"(seeded weights); num_epochs {HOST_EPOCHS} (run A), 1 then "
            f"{HOST_EPOCHS} (run B); save_every 0, save_best false and "
            "save_final_model false except run B's first part; phase 11's "
            "four 1024x1024 images")
        no_saves = dict(save_every=0, save_best=False)
        cfg_a = _host_entry_config(root, "run_a", num_epochs=HOST_EPOCHS,
                                   save_final_model=False, **no_saves)
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        trainer, steps, _ = _run_main(
            ["--config", str(cfg_a), "--output-dir", str(root / "out_a"),
             "--device", DEVICE], events=True)
        launches = _launches(HOST_KERNELS)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        opt = trainer.optimizer
        dev_gib, host_gib = _resident_bytes(trainer.state.opt_state)
        host = _host_tensors(trainer.state.opt_state)
        pinned = all(t.is_pinned() for t in host)
        for i, s in enumerate(steps):
            log(f"phase 14c run A step {i + 1}: latents {s['shape']}, loss "
                f"{s['loss']:.6f}; forward+backward {s['fwd_bwd_ms']:.2f} + "
                f"clip {s['clip_ms']:.2f} + update {s['opt_ms']:.2f} ms "
                "(CUDA events)")
        log(f"phase 14c run A: {type(opt).__name__} moments {opt.moments}, "
            f"shift_host {opt.shift_host}, moments_host {opt.moments_host}, "
            f"stream_group_params {opt.stream_group_params}; optimizer state "
            f"on the card {dev_gib:.4f} GiB, on the host {host_gib:.2f} GiB "
            f"({len(host)} tensors, all pinned {pinned}); peak "
            f"{peak_gb:.2f} GiB; launches {launches}")
        check(len(steps) == n_steps and trainer.state.step == n_steps,
              f"14c run A: {len(steps)} steps")
        check(all(np.isfinite(s["loss"]) for s in steps), "14c: a loss")
        check(opt.shift_host and opt.moments_host and opt.moments == "int8",
              "14c: the config's optimizer settings did not reach it")
        check(dev_gib < 1e-3 and pinned, f"14c: {dev_gib} GiB of state on "
              f"the card, pinned {pinned}")
        for k, n in launches.items():
            check(n > 0, f"kernel {k} was not launched in phase 14c")
        ref, ref_meta = _state_snapshot(trainer.state)
        overlap = _copy_overlap(trainer)
        del trainer
        _free()
        cfg_b1 = _host_entry_config(root, "run_b1", num_epochs=1,
                                    save_final_model=True, **no_saves)
        _run_main(["--config", str(cfg_b1), "--output-dir",
                   str(root / "out_b"), "--device", DEVICE])
        _free()
        cfg_b2 = _host_entry_config(root, "run_b2", num_epochs=HOST_EPOCHS,
                                    save_final_model=False, **no_saves)
        trainer, steps_b2, _ = _run_main(
            ["--config", str(cfg_b2), "--output-dir", str(root / "out_b"),
             "--resume", "--device", DEVICE])
        got, meta = _state_snapshot(trainer.state)
        restore_s = trainer.restore_seconds
        del trainer
        _free()
        differ = [k for k in ref if not torch.equal(ref[k], got.get(k))]
        log(f"phase 14c resume vs uninterrupted: restored in "
            f"{restore_s:.2f} s, {len(ref)} tensors, {len(differ)} differ "
            f"{differ[:3]}; step and generators equal {meta == ref_meta}")
        check(set(got) == set(ref) and not differ,
              f"14c resume: tensors differ {differ[:3]}")
        check(meta == ref_meta, "14c resume: step or generator states")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 14c wall time {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, steps=steps, peak_gb=peak_gb,
                device_gib=dev_gib, host_gib=host_gib, overlap=overlap)


def phase_training_settings() -> dict:
    """Phase 14: the default ``Config()`` model (bf16, b4 1024^2, remat)
    through 14a and 14b, then, that model freed, #7's rbg variant and the
    stacked launch against plain, then 14c."""
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    t_phase = time.perf_counter()
    cfg = Config()
    model = SDXLModel.create(
        tiny=False, dtype=torch.bfloat16, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        unet_config=UNetConfig.sdxl(remat=True))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    n = cfg.training.batch_size * cfg.training.gradient_accumulation_steps
    batch = _train_batch(model, n, gen, SIZE)
    log(f"phase 14a: every remat policy on the default Config() (ddpm, "
        f"v-prediction, adamw_bf16 per-leaf hash), b{n} at {SIZE}^2, "
        "seeded weights and latents")
    remat = phase_remat_policies(model, cfg, batch)
    log(f"phase 14a wall time {time.perf_counter() - t_phase:.1f} s")
    t_b = time.perf_counter()
    layouts = phase_layouts(model, cfg, batch)
    del model, batch
    _free()
    checks = dict(
        leaf=_adamw_rbg_case(INT8_LEAF, gen),
        group=_adamw_rbg_case((max(layouts["flat_sizes"]),), gen,
                              flat_g=True),
        stack=_stack_decay_case(*max(
            (s for s in layouts["stacks"] if s[0] * s[1] <= STACK_CHECK_MAX),
            key=lambda s: s[0]), gen))
    _free()
    log(f"phase 14b wall time {time.perf_counter() - t_b:.1f} s")
    host = phase_host_state()
    log(f"phase 14 wall time {time.perf_counter() - t_phase:.1f} s")
    return dict(remat=remat, layouts=layouts, checks=checks, host=host)


# ---------------------------------------------------------------- phase 15
# the ranks of phase 15: the cards the machine shows, at most this many
MULTI_MAX_RANKS = 4
MULTI_TIMEOUT_S = 600  # a rank that has not finished by then fails it
# 15c run A over phase 11's first bucket, one step an epoch (both buckets
# until the script outgrew its time limit); run B takes 1, saves, and
# resumes for 1
MULTI_EPOCHS = 2
# JAX's bars for a world of more than one rank (tests/test_trainer.py)
MULTI_LOSS_RTOL, MULTI_PARAM_ATOL = 2e-4, 2e-4


def _nccl_ms(prof) -> float:
    """Device ms of NCCL's kernels in a profiled window."""
    return sum(ms for name, ms in _device_events(prof)
               if "nccl" in name.lower())


def _opt_state_gib(state) -> float:
    from sdxl_training_improvements_tpu_torch.training import checkpoints
    tensors, _ = checkpoints.flatten_train_state(state)
    return sum(t.numel() * t.element_size() for k, t in tensors.items()
               if k.startswith("opt.")) / 2 ** 30


@contextlib.contextmanager
def _recording_loss(method: str, rows: list, per_row: bool = False):
    """Within the block ``get_method(method)`` (which ``make_train_step``
    calls) returns the method wrapped to append each call's loss to
    ``rows``; with ``per_row``, the first call also appends each row's
    loss from the same forward (a one-hot tag weight of B on row r makes
    the micro-batch's mean that row's loss, exactly)."""
    from sdxl_training_improvements_tpu_torch.training import methods
    fn = methods.LOSS_REGISTRY[method]

    def recorded(apply, batch, gen, schedule, mcfg):
        loss, m = fn(apply, batch, gen, schedule, mcfg)
        rows.append(loss.item())
        b = batch["vae_latents"].shape[0]
        if per_row and len(rows) == 1 and b > 1:
            with torch.no_grad():
                for r in range(b):
                    tw = torch.zeros(b, device=loss.device)
                    tw[r] = b
                    rows.append(fn(apply, dict(batch, tag_weights=tw), gen,
                                   schedule, mcfg)[0].item())
        return loss, m
    methods.LOSS_REGISTRY[method] = recorded
    try:
        yield rows
    finally:
        methods.LOSS_REGISTRY[method] = fn


def _param_diff(a, b: dict) -> tuple:
    """(the largest |a - b| over every leaf, the count of elements that
    differ); ``a``: (name, tensor) pairs."""
    worst, n = 0.0, 0
    for k, x in a:
        d = (x.float() - b[k].float()).abs()
        worst = max(worst, d.max().item())
        n += int((d > 0).sum().item())
    return worst, n


def _whole_leaves(zero, params: dict):
    """(name, the one-card leaf) of each parameter, gathered one leaf at a
    time (a collective), so that no whole copy of the UNet is held."""
    for k, p in params.items():
        yield k, zero.whole_params({k: p})[k]


def _matched_reference(model, start, ref) -> dict:
    """What phase 15b holds a mesh of W > 1 ranks to, on this rank's card
    from ``start``: (phase6) phase 6's first step again, its per-row
    losses from the b4 forward and the parameters after it; (matched)
    ``TRAIN_STEPS`` steps of the one-card run that takes a rank's shapes,
    phase 6's batch as micro-batches of one row accumulated
    (``tpu.micro_batch_size`` 1), its generator then set to where the
    mesh step's one micro-batch leaves it, so that both draw the same
    seeds at every step: its losses, grad norms, each row's loss at
    every step and the parameters after step 1.  The mesh's finite guard
    decides on the batch's mean, a micro-batch's on its own row; so the
    matched run lifts the guard's ceiling, and keeps every row as the
    mesh's guard does while each step's mean stays under it (which
    ``_phase15b`` checks)."""
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.training import methods
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        _SEED_HIGH, create_train_state, make_train_step)
    batch = {k: v.to(DEVICE) for k, v in ref["batch"].items()}
    n = next(iter(batch.values())).shape[0]
    out = {}
    for label, micro, n_steps in (("phase6", None, 1),
                                  ("matched", 1, TRAIN_STEPS)):
        with torch.no_grad():
            for k, p in model.trainable_params().items():
                p.copy_(start[k])
        cfg = Config()
        cfg.tpu.micro_batch_size = micro
        opt = make_optimizer(cfg)
        rows: list = []
        with _recording_loss(cfg.training.method, rows,
                             per_row=micro is None):
            step = make_train_step(model.unet_apply,
                                   NoiseSchedule.from_config(cfg), opt, cfg)
        state = create_train_state(model.trainable_params(), opt,
                                   seed=cfg.training.seed)
        losses, norms = [], []
        for i in range(n_steps):
            drawn = state.generator.get_state()
            with (mock.patch.object(methods, "LOSS_CLAMP", math.inf)
                  if micro is not None else contextlib.nullcontext()):
                state, metrics = step(state, batch)
            if micro is not None:  # the draws of one micro-batch of n rows
                g = torch.Generator()
                g.set_state(drawn)
                torch.randint(0, _SEED_HIGH, (n, 2), generator=g)
                torch.randint(0, _SEED_HIGH, (1,), generator=g)
                state.generator.set_state(g.get_state())
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            if i == 0:
                params1 = {k: p.detach().clone()
                           for k, p in state.params.items()}
                row_losses = rows[1:n + 1] if micro is None else rows[:n]
        out[label] = dict(losses=losses, grad_norms=norms,
                          row_losses=row_losses, params1=params1,
                          rows=rows)
        del state, step, opt
        _free()
    return out


def _mesh_steps(model, start, ref, shape, shard, smi, label="15b",
                place: bool = False, matched: Optional[dict] = None,
                store: bool = True) -> dict:
    """Phase 15b (16) on this rank: the default ``Config()`` on mesh
    ``shape`` from the seeded parameters ``start``, ``TRAIN_STEPS`` steps
    on phase 6's batch; the last under the profiler.  ``place`` (or
    ``shard``): the model's UNet is placed on the mesh, in place
    (``shard_train_state(unet=)``): split over its tensor axis, and with
    ``shard`` each rank stores only its fsdp chunks, which every unit
    gathers to run (given back whole after the steps; ``store`` False:
    the UNet is not given, so the parameters stay whole, their optimizer
    state chunked, as under LoRA).  ``matched``: what
    ``_matched_reference`` returned, which a mesh that splits the batch
    is held to (W > 1)."""
    from torch.profiler import ProfilerActivity, profile

    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        create_train_state, make_train_step, shard_train_state)
    rank = M.process_index()
    cfg = Config()
    cfg.tpu.mesh_shape, cfg.tpu.shard_params = list(shape), shard
    with torch.no_grad():
        for k, p in model.trainable_params().items():
            p.copy_(start[k])
    batch = {k: v.to(DEVICE) for k, v in ref["batch"].items()}
    names = TRAIN_KERNELS + ("fused_adamw_strided", "probe")
    _zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh = M.create_mesh(shape, device_type=DEVICE)
    opt = make_optimizer(cfg)
    local: list = []  # this rank's own loss, each step (W > 1)
    with (_recording_loss(cfg.training.method, local) if matched is not None
          else contextlib.nullcontext()):
        step = make_train_step(model.unet_apply,
                               NoiseSchedule.from_config(cfg), opt, cfg,
                               mesh=mesh)
    state = shard_train_state(create_train_state(
        model.trainable_params(), opt, seed=cfg.training.seed), mesh, shard,
        unet=model.unet if place or (shard and store) else None)
    zero = state.zero
    # the peak so far: the one-card state that the placement cut
    placed_peak = torch.cuda.max_memory_allocated()
    opt_gib = _opt_state_gib(state)
    param_gib = sum(p.numel() * p.element_size()
                    for p in state.params.values()) / 2 ** 30
    rows = []
    diffs = {}
    for i in range(TRAIN_STEPS):
        before = _launches(names)
        collectives = (zero.gathers, zero.scatters)
        events: dict = {}
        profiled = i == TRAIN_STEPS - 1
        if profiled:  # the last step's own peak, above what it starts with
            torch.cuda.synchronize()
            peak_before = torch.cuda.max_memory_allocated()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with ExitStack() as stack:
            if profiled:
                prof = stack.enter_context(
                    profile(activities=[ProfilerActivity.CUDA]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, events)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if profiled:
            step_peak = torch.cuda.max_memory_allocated()
        after = _launches(names)
        if matched is not None and i == 0:  # the parameters after step 1
            diffs = {k: _param_diff(_whole_leaves(zero, state.params),
                                    matched[k]["params1"])
                     for k in ("phase6", "matched")}
        row = dict(loss=metrics["loss"].item(),
                   grad_norm=metrics["grad_norm"].item(), wall_ms=wall_ms,
                   step_ms=events["start"].elapsed_time(events["update"]),
                   launches={k: after[k] - before[k] for k in names},
                   gathers=zero.gathers - collectives[0],
                   scatters=zero.scatters - collectives[1])
        if profiled:
            row["device_ms"] = sum(ms for _, ms in _device_events(prof))
            row["nccl_ms"] = _nccl_ms(prof)
        rows.append(row)
    launches = _launches(names)
    out = dict(
        mesh=list(shape), shard_params=shard,
        sharded_leaves=len(zero.chunks), stored=zero.stored,
        split_leaves=len(zero.tp), opt_state_gib=opt_gib,
        param_gib=param_gib, grad_gib=zero.grad_bytes / 2 ** 30,
        fsdp_gathers_per_step=rows[-1]["gathers"],
        fsdp_scatters_per_step=rows[-1]["scatters"],
        peak_gib=max(peak_before, step_peak) / 2 ** 30,
        held_gib=held / 2 ** 30, step_peak_gib=step_peak / 2 ** 30,
        placed_peak_gib=placed_peak / 2 ** 30,
        losses=[r["loss"] for r in rows],
        grad_norms=[r["grad_norm"] for r in rows],
        step_ms=[r["step_ms"] for r in rows],
        wall_ms=[r["wall_ms"] for r in rows],
        device_ms=rows[-1]["device_ms"], nccl_ms=rows[-1]["nccl_ms"],
        adamw_launches_per_step=rows[-1]["launches"]["fused_adamw"]
        + rows[-1]["launches"]["fused_adamw_strided"],
        strided_launches_per_step=rows[-1]["launches"][
            "fused_adamw_strided"],
        launches=launches)
    log(f"[rank {rank}] phase {label} mesh {list(shape)} shard_params "
        f"{shard} ({smi}): memory a rank: parameters "
        f"{out['param_gib']:.3f} GiB (stored as fsdp chunks: "
        f"{out['stored']}), gradient accumulator {out['grad_gib']:.3f} "
        f"GiB, optimizer state {opt_gib:.3f} GiB; peak {out['peak_gib']:.2f}"
        f" GiB over the phase ({out['placed_peak_gib']:.2f} GiB by the end "
        f"of the placement), {out['step_peak_gib']:.2f} GiB in the last "
        f"step, which starts holding {out['held_gib']:.2f} GiB (the "
        f"state, the seeded start and the references); fsdp all-gathers "
        f"{out['fsdp_gathers_per_step']} and reduce-scatters "
        f"{out['fsdp_scatters_per_step']} a step")
    log(f"[rank {rank}] phase {label} mesh {list(shape)} shard_params "
        f"{shard} ({smi}): sharded leaves {out['sharded_leaves']}, split "
        f"leaves {out['split_leaves']}; step ms (CUDA "
        f"events) {[round(x, 2) for x in out['step_ms']]}; profiled step "
        f"device {out['device_ms']:.2f} ms, NCCL kernels "
        f"{out['nccl_ms']:.3f} ms; #7 launches a step "
        f"{out['adamw_launches_per_step']} (strided "
        f"{out['strided_launches_per_step']}); optimizer state "
        f"{opt_gib:.3f} GiB; peak {out['peak_gib']:.2f} GiB; losses "
        f"{out['losses']}; grad norms {out['grad_norms']}")
    world = M.process_count()
    if world == 1:  # bit for bit phase 6's meshless steps
        check(out["losses"] == ref["losses"]
              and out["grad_norms"] == ref["grad_norms"],
              f"{label} {list(shape)}: losses {out['losses']} / grad norms "
              f"{out['grad_norms']} are not phase 6's {ref['losses']} / "
              f"{ref['grad_norms']}")
        check(torch.equal(param_digest(state.params), ref["final"]),
              f"{label} {list(shape)}: parameters differ from phase 6's")
    elif matched is None:  # JAX's bars (tests/test_trainer.py:268-274)
        for a, b in zip(out["losses"], ref["losses"]):
            check(abs(a - b) <= MULTI_LOSS_RTOL * abs(b),
                  f"{label} {list(shape)}: loss {a} vs phase 6's {b}")
    else:
        # JAX's test holds one sharded step to the unsharded one: step 1's
        # loss (rtol 2e-4) and the parameters after it (atol 2e-4).  Steps
        # 2-3 follow bf16 stochastic-rounding decisions that the rank's
        # b1 forward and the reduction's order move, so they are held to
        # the one-card run of the same shapes (``_matched_reference``).
        p6, mt = matched["phase6"], matched["matched"]
        log(f"[rank {rank}] {label} {list(shape)} against phase 6 (b4 "
            f"forward) and the matched run (4 micro-batches of 1): step-1 "
            f"loss of this rank's row {local[0]!r}, the rows' losses b4 "
            f"{p6['row_losses']} / b1 {mt['row_losses']}; losses "
            f"{out['losses']} vs phase 6's {ref['losses']} vs matched "
            f"{mt['losses']}; grad norms {out['grad_norms']} vs "
            f"{ref['grad_norms']} vs {mt['grad_norms']}; parameters after "
            f"step 1 (largest difference, bf16 elements that differ): vs "
            f"phase 6 {diffs['phase6']}, vs matched {diffs['matched']}")
        a, b = out["losses"][0], ref["losses"][0]
        check(abs(a - b) <= MULTI_LOSS_RTOL * abs(b),
              f"{label} {list(shape)}: step-1 loss {a} vs phase 6's {b}")
        check(diffs["phase6"][0] <= MULTI_PARAM_ATOL,
              f"{label} {list(shape)}: the parameters after step 1 differ "
              f"from phase 6's by {diffs['phase6'][0]}")
        for i in range(1, TRAIN_STEPS):
            a, b = out["losses"][i], mt["losses"][i]
            check(abs(a - b) <= MULTI_LOSS_RTOL * abs(b),
                  f"{label} {list(shape)}: step-{i + 1} loss {a} vs the "
                  f"matched run's {b}")
        out["against"] = dict(local_loss=local[0], diffs=diffs)
    # a split leaf laid out [out, in] (the seeded model's) is strided in
    # a row split and in the GEGLU's halves
    used = TRAIN_KERNELS + ("probe",) + (
        ("fused_adamw_strided",) if out["split_leaves"] else ())
    for k in used:
        check(launches[k] > 0, f"{label} {list(shape)}: kernel {k} was not "
              "launched")
    out["params"] = ({k: p.detach().clone() for k, p in
                      zero.whole_params(state.params).items()}
                     if world > 1 and not out["split_leaves"] else None)
    if zero.stored:  # the model's parameters whole again for what follows
        zero.unstore(state.params, model.unet)
    del state, step, opt, zero
    return out


def _phase15b(model, start, ref, smi: str) -> dict:
    """Phase 15b on this rank: the full-width default model from the
    seeded parameters ``start``, mesh [W,1,1] then [1,W,1] with
    ``shard_params``."""
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    from sdxl_training_improvements_tpu_torch.training.methods import (
        LOSS_CLAMP)
    world = M.process_count()
    matched = None
    if world > 1:
        matched = _matched_reference(model, start, ref)
        p6 = matched["phase6"]["losses"][0]
        log(f"[rank {M.process_index()}] 15b: phase 6's step 1 again on "
            f"this card: loss {p6!r} vs phase 6's {ref['losses'][0]!r}; "
            f"the matched run {matched['matched']['losses']}")
        check(p6 == ref["losses"][0], "15b: phase 6's step 1 on this card "
              "is not phase 6's")
        rows = matched["matched"]["rows"]
        n = len(rows) // TRAIN_STEPS
        means = [sum(rows[i * n:(i + 1) * n]) / n for i in range(TRAIN_STEPS)]
        check(all(np.isfinite(rows)) and max(means) <= LOSS_CLAMP,
              f"15b: the matched run's batch means {means} leave the finite "
              "guard's range, where the mesh's guard would clamp")
    dp = _mesh_steps(model, start, ref, (world, 1, 1), False, smi,
                     matched=matched)
    dp_params = dp.pop("params")
    out = dict(dp=dp)
    # [1,W,1], and at W >= 4 [2,W/2,1] too, each rank storing its chunks;
    # at W >= 4 also [1,W,1] with the parameters whole (the optimizer
    # state chunked), to hold the memory and the time against.  One card:
    # [1,1,1] was just run (nothing chunks at fsdp = 1; both runs logged
    # the same step until the script outgrew its time limit)
    meshes = ([("zero", (1, world, 1), True)] if world > 1 else []) + (
        [("hybrid", (2, world // 2, 1), True),
         ("zero_whole_params", (1, world, 1), False)] if world >= 4 else [])
    for key, shape, store in meshes:
        out[key] = _mesh_steps(model, start, ref, shape, True, smi,
                               matched=matched, store=store)
        params = out[key].pop("params")
        if world > 1:
            for a, b in zip(out[key]["losses"], dp["losses"]):
                check(abs(a - b) <= MULTI_LOSS_RTOL * abs(b),
                      f"15b: {list(shape)} loss {a} vs [W,1,1] {b}")
            worst = max((params[k].float() - dp_params[k].float()).abs()
                        .max().item() for k in dp_params)
            log(f"[rank {M.process_index()}] 15b {list(shape)} against "
                f"[{world},1,1]: max parameter difference {worst:.3e}")
            check(worst <= MULTI_PARAM_ATOL,
                  f"15b {list(shape)} parameters differ by {worst}")
        del params
    del matched, dp_params
    return out


def _phase16(model, start, ref, smi: str) -> dict:
    """Phase 16 on this rank: the full-width default model on mesh
    [1,1,W], megatron-split over the W cards: phase 5's text-to-image
    call through ``SDXLPipeline(mesh=)`` (a split copy of the UNet), then
    phase 6's 3 steps with the UNet split in place.  One card: the tensor
    code path at T = 1, latents, losses, grad norms and parameter digests
    bit for bit phases 5 and 6; more: NCCL at T = W, within phase 15's
    bars (the latents within ``SLICE_REL_L2_TOL``)."""
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    from sdxl_training_improvements_tpu_torch.training.validation import (
        latents_to_images)
    rank, world = M.process_index(), M.process_count()
    shape = (1, 1, world)
    with torch.no_grad():
        for k, p in model.trainable_params().items():
            p.copy_(start[k])
    mesh = M.create_mesh(shape, device_type=DEVICE)
    pipe = SDXLPipeline.from_model(model, mesh=mesh)
    _zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    latents = pipe(["a photograph of an astronaut riding a horse"],
                   height=SERVE_SIZE, width=SERVE_SIZE,
                   num_inference_steps=STEPS, guidance_scale=5.0, seed=SEED,
                   return_latents=True)
    with torch.inference_mode():  # the image, as phase 5's call makes it
        image = latents_to_images(model.decode_latents(latents))[0]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = _launches(SERVING_KERNELS)
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase5 = ref["latents"].to(latents.device)
    equal = torch.equal(latents, phase5)
    rel = ((latents.float() - phase5.float()).norm()
           / phase5.float().norm()).item()
    log(f"[rank {rank}] phase 16 serving on mesh {list(shape)} ({smi}): "
        f"{SERVE_SIZE}x{SERVE_SIZE} euler {STEPS} steps in {serve_s:.2f} s, peak "
        f"{serve_peak:.2f} GiB; latents vs phase 5's: torch.equal {equal}, "
        f"rel L2 {rel:.3e}; launches {serve_launches}")
    if world == 1:
        check(equal, "16: the latents are not phase 5's")
    else:
        check(rel <= SLICE_REL_L2_TOL, f"16: latents rel L2 {rel}")
    check(image.shape == (SERVE_SIZE, SERVE_SIZE, 3)
          and image.dtype == np.uint8, f"16: image {image.shape}")
    for k, n in serve_launches.items():
        check(n > 0, f"16 serving: kernel {k} was not launched")
    del pipe, latents, image
    _free()
    train = _mesh_steps(model, start, ref, shape, False, smi, label="16",
                        place=True)
    train.pop("params")
    return dict(serve=dict(seconds=serve_s, peak_gib=serve_peak,
                           equal=equal, rel_l2=rel,
                           launches=serve_launches), train=train)


def _multi_entry(work: Path, name: str, epochs: int, resume: bool = False,
                 save: bool = False) -> tuple:
    """One 15c ``main.main`` run over the ranks: (trainer, steps)."""
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    world = M.process_count()
    cfg = work / f"{name}.yaml"
    if M.is_main_process() and not cfg.exists():
        _entry_config(work, name, num_epochs=epochs, save_every=0,
                      save_best=False, save_final_model=save, log_every=1)
        from sdxl_training_improvements_tpu_torch import _yaml
        raw = _yaml.load_file(cfg)
        raw["global_config"]["cache"]["partitioned"] = True
        # phase 11's micro-batches of one row become one row per rank
        raw["tpu"] = dict(raw.get("tpu") or {}, mesh_shape=[1, world, 1],
                          shard_params=True, micro_batch_size=world)
        cfg.write_text(_yaml.dump(raw))
    M.barrier(f"15c config {name}")
    argv = ["--config", str(cfg), "--output-dir", str(work / name),
            "--device", DEVICE]
    if resume:
        argv += ["--resume"]
    trainer, steps, _ = _run_main(argv)
    return trainer, steps


def _phase15c(work: Path, smi: str) -> dict:
    """Phase 15c on this rank: ``main.main`` on phase 11's recipe and cuts
    with the partitioned cache over the ranks, mesh [1,W,1] with
    ``shard_params``: run A ``MULTI_EPOCHS`` epochs; run B 1 epoch with
    the final checkpoint, then ``--resume`` to the same epoch count."""
    from sdxl_training_improvements_tpu_torch.core.logging import (
        cleanup_logging)
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    from sdxl_training_improvements_tpu_torch.training import checkpoints
    rank, world = M.process_index(), M.process_count()
    names = ENTRY_KERNELS
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a, a_steps = _multi_entry(work, "multi_a", MULTI_EPOCHS)
    launches = _launches(names)
    zero = a.state.zero
    memory = dict(
        stored=zero.stored, param_gib=sum(
            p.numel() * p.element_size() for p in a.state.params.values())
        / 2 ** 30, grad_gib=zero.grad_bytes / 2 ** 30,
        fsdp_gathers_per_step=zero.gathers / max(1, a.state.step),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"[rank {rank}] phase 15c run A ({smi}): memory a rank: parameters "
        f"{memory['param_gib']:.3f} GiB (stored as fsdp chunks: "
        f"{memory['stored']}), gradient accumulator "
        f"{memory['grad_gib']:.3f} GiB, peak {memory['peak_gib']:.2f} GiB;"
        f" fsdp all-gathers {memory['fsdp_gathers_per_step']:.1f} a step")
    del zero
    ds = a.dataset
    cache_dir = Path(ds.cache.cache_dir)
    images = sum(len(v) for v in ds.bucket_indices.values())
    expect = (work / "cache" / f"host-{rank:03d}" if world > 1
              else work / "cache")
    a_tensors, a_meta = checkpoints.flatten_train_state(a.state)
    a_tensors = {k: v.detach() for k, v in a_tensors.items()}
    a_step = a.state.step
    del a
    cleanup_logging()
    t1 = time.perf_counter()
    _multi_entry(work, "multi_b", 1, save=True)
    cleanup_logging()
    t2 = time.perf_counter()
    b, b_steps = _multi_entry(work, "multi_b2", MULTI_EPOCHS, resume=True)
    t3 = time.perf_counter()
    b_tensors, b_meta = checkpoints.flatten_train_state(b.state)
    equal = (set(a_tensors) == set(b_tensors) and a_meta == b_meta
             and all(torch.equal(a_tensors[k], b_tensors[k])
                     for k in a_tensors))
    out = dict(
        cache_dir=str(cache_dir), images=images,
        steps=a_step, resumed_losses=[s["loss"] for s in b_steps],
        losses=[s["loss"] for s in a_steps], resume_equal=equal,
        launches=launches, run_a_s=t1 - t0, run_b_s=t2 - t1,
        resume_s=t3 - t2, memory=memory,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"[rank {rank}] phase 15c ({smi}): cache {cache_dir} ({images} "
        f"images of this rank); run A {a_step} steps in {t1 - t0:.1f} s, "
        f"losses {out['losses']}; run B 1 epoch + save {t2 - t1:.1f} s, "
        f"--resume {t3 - t2:.1f} s; resume torch.equal to run A: {equal}; "
        f"peak {out['peak_gib']:.2f} GiB; run A launches {launches}")
    check(cache_dir == expect, f"15c: rank {rank}'s cache is {cache_dir}, "
          f"not {expect}")
    check(equal, "15c: the resumed run is not torch.equal to run A")
    for k in names:
        check(launches[k] > 0, f"15c: kernel {k} was not launched")
    del b, a_tensors, b_tensors
    cleanup_logging()
    _free()
    return out


def _phase15_rank(work: str) -> None:
    """One rank of phases 15 and 16 (``python chip_smoke.py --phase15-rank
    DIR`` under the env triple): 15a, 15b, 16 on 15b's model, 15c; its
    results to ``DIR/rank<r>.json``."""
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    from sdxl_training_improvements_tpu_torch.parallel import dryrun
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    work = Path(work)
    M.initialize_multihost(DEVICE)
    rank, world = M.process_index(), M.process_count()
    smi = (work / "smi.txt").read_text().strip()
    t0 = time.perf_counter()
    losses = dryrun.dryrun_multichip(
        world, DEVICE, log=lambda m: log(f"[rank {rank}] 15a {m}"))
    t1 = time.perf_counter()
    ref = torch.load(work / "phase6.pt")
    cfg = Config()
    model = SDXLModel.create(
        tiny=False, dtype=torch.bfloat16, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        unet_config=UNetConfig.sdxl(remat=cfg.tpu.remat,
                                    remat_policy=cfg.tpu.remat_policy))
    check(torch.equal(param_digest(model.trainable_params()), ref["initial"]),
          "15b: the seeded parameters differ from phase 6's")
    start = {k: p.detach().clone()
             for k, p in model.trainable_params().items()}
    steps = _phase15b(model, start, ref, smi)
    t2 = time.perf_counter()
    tensor = _phase16(model, start, ref, smi)
    del model, start
    _free()
    t3 = time.perf_counter()
    entry = _phase15c(work, smi)
    t4 = time.perf_counter()
    out = dict(rank=rank, world=world, dryrun=losses, **steps, tp=tensor,
               entry=entry, seconds=dict(dryrun=t1 - t0, steps=t2 - t1,
                                         tensor=t3 - t2, entry=t4 - t3))
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    M.barrier("phase 15 done")
    torch.distributed.destroy_process_group()


def phase_multi_card(record: dict, tmp: Path) -> dict:
    """Phase 15: W ranks (the cards the machine shows, at most
    ``MULTI_MAX_RANKS``), one process each on NCCL through JAX's env
    triple: 15a the dry-run matrix, 15b the default ``Config()`` on
    [W,1,1] and on [1,W,1] with ``shard_params`` (one card:
    ``torch.equal`` to phase 6), 15c ``main.main`` with the partitioned
    cache and a bit-equal ``--resume``.  Returns rank 0's results."""
    import os
    import socket
    # a power of two: the global batch of 4 splits evenly over the ranks
    world = max(w for w in (1, 2, 4) if w <= min(torch.cuda.device_count(),
                                                  MULTI_MAX_RANKS))
    work = tmp / "multi"
    work.mkdir()
    smi = _card(DEVICE)
    (work / "smi.txt").write_text(smi)
    torch.save(record, work / "phase6.pt")
    _entry_images(work / "images", first_bucket=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    log(f"phase 15: {world} rank(s) over NCCL ({smi})")
    t0 = time.perf_counter()
    procs = []
    for r in range(world):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                   SDXL_NUM_PROCESSES=str(world), SDXL_PROCESS_ID=str(r),
                   LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phase15-rank",
             str(work)], env=env))
    try:
        for p in procs:
            left = MULTI_TIMEOUT_S - (time.perf_counter() - t0)
            p.wait(timeout=max(left, 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    check(all(c == 0 for c in codes), f"phase 15 ranks exited {codes}")
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(world)]
    for r in ranks:
        for phase, m in (("15b", r["dp"]), ("15b", r.get("zero")),
                         ("15b", r.get("hybrid")),
                         ("15b", r.get("zero_whole_params")),
                         ("16", r["tp"]["train"])):
            if m is None:  # [1,W,1] at W >= 2, the others at W >= 4
                continue
            log(f"phase {phase} rank {r['rank']} of {world} mesh "
                f"{m['mesh']} (parameters stored as chunks: "
                f"{m['stored']}; {smi}): step device {m['device_ms']:.2f} ms, "
                f"NCCL {m['nccl_ms']:.3f} ms a step, peak "
                f"{m['peak_gib']:.2f} GiB (last step {m['step_peak_gib']:.2f}"
                f"), parameters {m['param_gib']:.3f} GiB, gradient "
                f"accumulator {m['grad_gib']:.3f} GiB, optimizer state "
                f"{m['opt_state_gib']:.3f} GiB, fsdp all-gathers "
                f"{m['fsdp_gathers_per_step']} a step, #7 "
                f"{m['adamw_launches_per_step']} launches a step (strided "
                f"{m['strided_launches_per_step']}), split leaves "
                f"{m['split_leaves']}")
    log(f"phases 15-16 wall time {time.perf_counter() - t0:.1f} s (ranks: "
        f"{[r['seconds'] for r in ranks]})")
    return ranks[0]


# ------------------------------------------------- phase 17: the tools
# depth cut for the script's time (100 and 20 in a first run): the full
# curves, the study and finetune_demo's full-scale stage run on the card
# through the tools themselves (README, PERF.md)
TOOLS_PARITY_STEPS = 30  # of each 1000-step JAX curve
TOOLS_STUDY_STEPS = 10  # a study arm
STUDY_KERNELS = {"bf16": TRAIN_KERNELS, "int8": TRAIN_KERNELS,
                 "fp32": F32_TRAIN_KERNELS}


def _path_launches(names, fn):
    """(fn's result, the launches of every kernel during it), each name
    in ``names`` checked to have launched."""
    _zero_launches()
    result = fn()
    torch.cuda.synchronize()
    counts = _launches(KERNELS)
    for k in names:
        check(counts[k] > 0, f"{k} was not launched")
    return result, counts


def _sum_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_tools(ckpt: Path, tmp: Path) -> dict:
    """Phase 17: the port's tools (``sdxl_training_improvements_tpu_torch/
    tools``) on the card.  (17a) ``parity_check``: the first
    ``TOOLS_PARITY_STEPS`` steps of both JAX curves (the committed
    fixtures) through the kernels, at the north star's 1% bar; (17b)
    ``study_int8_moments``: ``TOOLS_STUDY_STEPS`` steps of each arm,
    finite, #7 launched in the bf16 and int8 arms; (17c)
    ``verify_checkpoint`` on phase 10's checkpoint (passes) and on a copy
    of its VAE with one key removed (fails).  Returns each part's
    launches.
    ``finetune_demo``'s full-scale stage (the 2.567B UNet + LoRA at 1024^2
    with the reload through ``SDXLPipeline``) ran here at 2 steps in a
    first run (18.1 s, phase 17 104.0 s of a 1235 s script) and now runs
    through the tool alone."""
    from sdxl_training_improvements_tpu_torch.models import weights as W
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    from sdxl_training_improvements_tpu_torch.tools import parity_check as P
    from sdxl_training_improvements_tpu_torch.tools import (
        study_int8_moments as S)
    from sdxl_training_improvements_tpu_torch.tools import (
        verify_checkpoint as V)
    t_phase = time.perf_counter()
    paths = {}

    # 17a: the loss curves against JAX's
    t0 = time.perf_counter()
    curves = {}

    def parity():
        for method, seed in P.CURVES:
            curves[method] = P.run_port(TOOLS_PARITY_STEPS, seed,
                                        method=method, device=DEVICE)
    _, paths["parity curves (phase 17a)"] = _path_launches(
        F32_TRAIN_KERNELS + ("probe",), parity)
    for method, seed in P.CURVES:
        ref = json.loads(P.fixture_path(method, seed).read_text())
        cmp = P.compare_curves(ref["losses"][:TOOLS_PARITY_STEPS],
                               curves[method])
        log(f"17a {method} seed {seed}: {cmp['steps_compared']} steps, max "
            f"rel {cmp['max_rel_divergence']:.3e} at step "
            f"{cmp['argmax_step']}, mean {cmp['mean_rel_divergence']:.3e} "
            f"(bar {P.TOL:g}); over the bar: {cmp['steps_over_tol']}")
        check(cmp["within_1pct"], f"17a {method} curve missed the 1% bar")
    log(f"17a {time.perf_counter() - t0:.1f} s")

    # 17b: the int8-moment study's arms
    t0 = time.perf_counter()
    start = P.seeded_unet_state(UNetConfig.tiny(), 0)
    arm_counts = []
    for arm in S.ARMS:
        (losses, _, sec), counts = _path_launches(
            STUDY_KERNELS[arm],
            lambda: S.run_arm(arm, TOOLS_STUDY_STEPS, DEVICE, start))
        log(f"17b {arm}: {TOOLS_STUDY_STEPS} steps in {sec:.2f} s, losses "
            f"{losses[0]:.5g} -> {losses[-1]:.5g}, #7 launches "
            f"{counts['fused_adamw']}")
        check(bool(np.isfinite(losses).all()), f"17b {arm} loss not finite")
        arm_counts.append(counts)
    paths["int8 study (phase 17b)"] = _sum_counts(*arm_counts)
    log(f"17b {time.perf_counter() - t0:.1f} s")

    # 17c: the checkpoint audit
    t0 = time.perf_counter()
    lines = []
    rc = V.verify(ckpt, out=lines.append)
    log(f"17c verify_checkpoint {ckpt.name}: rc {rc}; " + "; ".join(lines))
    check(rc == 0, "17c verify_checkpoint failed on phase 10's checkpoint")
    broken = tmp / "ckpt_missing_key"
    state = W.load_safetensors_dir(ckpt / "vae")
    dropped = sorted(state)[0]
    del state[dropped]
    W.save_safetensors(state, broken / "vae" /
                       "diffusion_pytorch_model.safetensors")
    del state
    lines = []
    rc = V.verify(broken, out=lines.append)
    log(f"17c with {dropped} removed: rc {rc}; " + "; ".join(lines))
    check(rc == 1, "17c verify_checkpoint passed a checkpoint missing a key")
    log(f"17c {time.perf_counter() - t0:.1f} s")
    log(f"phase 17 wall time {time.perf_counter() - t_phase:.1f} s")
    return paths


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
        max([r["err"] for r in k["adamw"]] + [k["adamw_base"]["hash"]["err"]]),
        adamw["ms"], adamw["plain_ms"],
        "[10240, 1280] bf16, fp32 g",
        bound(OPS_PER_ELEMENT["fused_adamw"] * adamw_n, (16 + 4) * adamw_n,
              PEAK_FP32), (None, None))
    measured["probe"] = (
        k["probe"]["max_abs_err"], k["probe"]["ms"], k["probe"]["plain_ms"],
        "[4096, 4096] fp32",
        bound(OPS_PER_ELEMENT["probe"] * probe_n, 8 * probe_n, PEAK_FP32),
        (k["probe"]["library_ms"], "torch.add(1, x, alpha=2)"))
    rbg = k["adamw_rbg"]
    measured["fused_adamw_rbg"] = (
        max(k["adamw_rbg_errs"] + [k["adamw_base"]["rbg"]["err"]]),
        rbg["ms"], rbg["plain_ms"],
        "[10240, 1280] bf16, fp32 g, rbg planes", rbg["bound"],
        (None, None))
    strided = k["adamw_strided"]
    st = next(r for r in strided if r["noise"] == "hash"
              and (r["kind"], r["tensor"]) == STRIDED_SLICES[0])
    measured["fused_adamw_strided"] = (
        max(r["err"] for r in strided), st["ms"], st["plain_ms"],
        f"rank 1's column slice of 2 of [10240, 1280] bf16 in the JAX "
        f"layout, fp32 g, hash ({st['index_map']})",
        (st["bound_ms"], st["bound_by"]), (None, None))
    device.update({"fused_adamw": adamw["dev"], "fused_adamw_rbg": rbg["dev"],
                   "fused_adamw_strided": st["device_ms"],
                   "probe": k["probe"]["dev"]})
    extra["fused_adamw_strided"] = {"slices": strided}
    for name, noise in (("fused_adamw", "hash"), ("fused_adamw_rbg", "rbg")):
        extra[name] = {"zero_chunk_at_base_n/2": k["adamw_base"][noise]}
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
    t_main = time.perf_counter()

    def elapsed(what: str) -> None:
        log(f"elapsed {time.perf_counter() - t_main:.1f} s after {what}")
    phase_environment()
    phase_build()
    kernels = phase_kernels()
    elapsed("phase 3")
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
    elapsed("phase 4")
    serving = phase_slice(model)
    elapsed("phase 5")
    record: dict = {"latents": serving.pop("latents")}  # for phase 16
    # phase 10's checkpoint stays for phase 17's audit
    serve_tmp = tempfile.TemporaryDirectory()
    rest = phase_rest_of_serving(model, Path(serve_tmp.name))
    entry_points = phase_serving_entry_points(model, Path(serve_tmp.name))
    elapsed("phases 10 and 13")
    profile_unet_step(model)
    train = phase_train(model, cfg, record=record)
    phase_train_parity(model, cfg)
    elapsed("phases 6-7")
    del model
    _free()
    fp16 = phase_fp16()
    elapsed("phase 8")
    fp32 = phase_fp32_training()
    elapsed("phase 9")
    decode = phase_decode()
    entry = phase_entry_point()
    entry["decode"] = decode
    elapsed("phase 11")
    lora = phase_lora_ema()
    elapsed("phase 12a")
    optimizers = phase_optimizers()
    elapsed("phases 12b-12e")
    settings = phase_training_settings()
    elapsed("phase 14")
    with tempfile.TemporaryDirectory() as tmp:
        multi = phase_multi_card(record, Path(tmp))
    elapsed("phases 15-16")
    with tempfile.TemporaryDirectory() as tmp:
        tools = phase_tools(Path(serve_tmp.name) / "ckpt", Path(tmp))
    serve_tmp.cleanup()
    elapsed("phase 17")
    kernels["adamw_rbg"] = settings["checks"]["leaf"]
    kernels["adamw_rbg_errs"] = [settings["checks"][c]["err"]
                                 for c in ("leaf", "group")]
    # each main path's launches, counted from 0 just before it ran
    paths = {"serving (phase 5)": serving["launches"],
             **{f"rest of serving (phase 10): {k}": v
                for k, v in rest.items()},
             **{f"aot {k}": v for k, v in entry_points.items()},
             "training (phase 6)": train["launches"],
             "fp16 (phase 8)": fp16["launches"],
             "fp32 training (phase 9)": fp32["train"]["launches"],
             "training entry point (phase 11)": entry["launches"],
             "LoRA + EMA entry point (phase 12a)": lora["launches"],
             "schedule-free (phase 12b)": optimizers["sf"]["launches"],
             "SOAP (phase 12c)": optimizers["soap"]["launches"],
             "int8 moments (phase 12d)": optimizers["int8"]["launches"],
             "full fine-tune + EMA (phase 12e)":
                 optimizers["ema"]["launches"],
             "remat policies (phase 14a)": settings["remat"]["launches"],
             "optimizer layouts (phase 14b)":
                 settings["layouts"]["launches"],
             "host-streamed state (phase 14c)":
                 settings["host"]["launches"],
             "mesh [W,1,1] (phase 15b, rank 0)": multi["dp"]["launches"],
             **({"mesh [1,W,1] + shard_params (phase 15b, rank 0)":
                 multi["zero"]["launches"]} if "zero" in multi else {}),
             "multi-rank entry point (phase 15c, rank 0)":
                 multi["entry"]["launches"],
             "mesh [1,1,W] serving (phase 16, rank 0)":
                 multi["tp"]["serve"]["launches"],
             "mesh [1,1,W] training (phase 16, rank 0)":
                 multi["tp"]["train"]["launches"],
             **tools}
    log(json.dumps(kernel_report(kernels, paths)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase15-rank"]:
        _phase15_rank(sys.argv[2])
    else:
        main()
