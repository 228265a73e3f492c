"""The end-to-end training proof: the port learns, and fine-tunes at full
scale.

Port of ``tools/finetune_demo.py``, every stage with JAX's recipe, seeds
and defaults.  No pretrained SDXL is in the repository, so, as in JAX's,
the proof has two halves:

* ``pretrain`` + ``lora`` (the learning proof, tiny model): a synthetic
  shapes dataset (a red circle, a blue square, a yellow cross; the
  held-out green triangle), a reconstruction-pretrained tiny VAE, a tiny
  SDXL trained on the three base concepts through the real trainer
  (``training/loop.py`` ``SDXLTrainer``) and exported as a diffusers
  checkpoint, then a LoRA fine-tune of the held-out concept from that
  checkpoint, sampled before and after through ``generate.main``.  JAX's
  concept gate decides: the mean over seeds, max over guidance, of the
  fraction of concept-coloured pixels must exceed max(before + 0.03,
  0.03) and 2x before;
* ``full-scale`` (the scale proof, on the card): the same LoRA recipe
  over the full 2.567B-parameter UNet at 1024x1024 from seeded weights,
  flow matching, rank 16, ``adamw_bf16``, batch 1, 300 steps, the export
  reloaded through ``SDXLPipeline.from_pretrained``.

The dataset is drawn without Pillow: a numpy rasterizer of Pillow's
``ImageDraw`` for the demo's shapes (rectangles, the triangle's scanline
fill and the ellipse's quarter iteration, pixel for pixel), written by
``png.py``.
Artifacts (loss curves, scores, samples) go to
``artifacts/finetune_demo_torch/``, checkpoints and caches to
``outputs/finetune_demo_torch/``; every JSON names the device and the
card's name and power limit.

    python -m sdxl_training_improvements_tpu_torch.tools.finetune_demo \\
        --stage all                 # pretrain + lora, on the card
    python -m sdxl_training_improvements_tpu_torch.tools.finetune_demo \\
        --stage full-scale          # 2.567B + LoRA, 300 steps
    ... --stage all --fast --device cpu   # tiny step counts (a smoke)
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.tools import card, require_device

REPO = Path(__file__).resolve().parents[2]
ART = REPO / "artifacts" / "finetune_demo_torch"
WORK = REPO / "outputs" / "finetune_demo_torch"

# ---------------------------------------------------------------- dataset

BASE_CONCEPTS = [("red", "circle"), ("blue", "square"), ("yellow", "cross")]
NEW_CONCEPT = ("green", "triangle")
COLORS = {"red": (220, 40, 40), "blue": (40, 70, 220),
          "yellow": (230, 210, 40), "green": (40, 200, 60)}
BG = (190, 190, 190)


def _rectangle(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
               c) -> None:
    """``ImageDraw.rectangle([x0, y0, x1, y1], fill=c)``: both corners
    inclusive."""
    img[y0:y1 + 1, x0:x1 + 1] = c


def _ellipse(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
             c) -> None:
    """``ImageDraw.ellipse([x0, y0, x1, y1], fill=c)``: Pillow's quarter
    iteration in doubled coordinates (``Draw.c`` ``quarter_next``: from
    (a, b % 2) to (a % 2, b), each step the one of three neighbours that
    deviates least from the curve), one span a row."""
    a, b = x1 - x0, y1 - y0
    a2, b2 = a * a, b * b

    def delta(x, y):
        return abs(a2 * y * y + b2 * x * x - a2 * b2)
    cx, cy = a, b % 2
    rows = {}
    while True:
        rows.setdefault(cy, cx)
        if cx == a % 2 and cy == b:
            break
        nx, ny = cx, cy + 2
        best = delta(nx, ny)
        if cx > 1:
            d = delta(cx - 2, cy + 2)
            if best > d:
                nx, ny, best = cx - 2, cy + 2, d
            if best > delta(cx - 2, cy):
                nx, ny = cx - 2, cy
        cx, cy = nx, ny
    for cy, cx in rows.items():
        for y in (cy, -cy):
            img[y0 + (y + b) // 2,
                x0 + (a - cx) // 2:x0 + (a + cx) // 2 + 1] = c


def _polygon(img: np.ndarray, pts, c) -> None:
    """``ImageDraw.polygon(pts, fill=c)``: Pillow's scanline fill
    (``Draw.c`` ``polygon_generic``): horizontal edges drawn as lines, each
    row's crossings x = (y - y0) dx + x0 in fp32 (a crossing at an edge's
    lower end counted twice above the last row), spans from one crossing
    rounded half up to the next rounded half down (x >= 0 here).  Pillow's
    vertex rules for other polygons are not reproduced: pixel for pixel
    for the demo's triangles (apex up, base level), not for any."""
    edges, ymin, ymax = [], None, None
    for (x0, y0), (x1, y1) in zip(pts, pts[1:] + pts[:1]):
        if y0 == y1:
            img[y0, min(x0, x1):max(x0, x1) + 1] = c
            continue
        if y0 > y1:
            x0, y0, x1, y1 = x1, y1, x0, y0
        edges.append((x0, y0, y1,
                      np.float32(x1 - x0) / np.float32(y1 - y0)))
        ymin = y0 if ymin is None else min(ymin, y0)
        ymax = y1 if ymax is None else max(ymax, y1)
    for y in range(ymin, ymax + 1):
        xs = []
        for x0, y0, y1, dx in edges:
            if y0 <= y <= y1:
                xs.append(np.float32(np.float32(y - y0) * dx + x0))
                if y == y1 and y < ymax:
                    xs.append(xs[-1])
        xs.sort()
        for i in range(1, len(xs), 2):
            lo = int(np.floor(xs[i - 1] + np.float32(0.5)))  # ROUND_UP
            hi = int(np.ceil(xs[i] - np.float32(0.5)))  # ROUND_DOWN
            if hi >= lo:
                img[y, lo:hi + 1] = c


def _draw(color: str, shape: str, rng: np.random.Generator,
          size: int = 64) -> np.ndarray:
    """One synthetic training image, uint8 [size, size, 3]: a solid shape
    on a gray background, with JAX's draws from ``rng``."""
    img = np.empty((size, size, 3), np.uint8)
    img[:] = BG
    c = COLORS[color]
    r = int(rng.integers(size // 5, size // 3))
    cx = int(rng.integers(r + 2, size - r - 2))
    cy = int(rng.integers(r + 2, size - r - 2))
    if shape == "circle":
        _ellipse(img, cx - r, cy - r, cx + r, cy + r, c)
    elif shape == "square":
        _rectangle(img, cx - r, cy - r, cx + r, cy + r, c)
    elif shape == "triangle":
        _polygon(img, [(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)], c)
    elif shape == "cross":
        w = max(2, r // 3)
        _rectangle(img, cx - r, cy - w, cx + r, cy + w, c)
        _rectangle(img, cx - w, cy - r, cx + w, cy + r, c)
    else:
        raise ValueError(shape)
    return img


def make_dataset(out_dir: Path, concepts, n_per: int, seed: int,
                 size: int = 64) -> int:
    from sdxl_training_improvements_tpu_torch.png import write_png
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = 0
    for color, shape in concepts:
        for i in range(n_per):
            stem = out_dir / f"{color}_{shape}_{i:03d}"
            write_png(stem.with_suffix(".png"), _draw(color, shape, rng,
                                                      size))
            stem.with_suffix(".txt").write_text(f"a {color} {shape}")
            n += 1
    return n


def _color_fraction(arr: np.ndarray, color: str) -> float:
    target = np.asarray(COLORS[color], np.float32)
    return float((np.linalg.norm(arr - target, axis=-1) < 90.0).mean())


def concept_score(png_path: Path, color: str) -> float:
    """Fraction of pixels within a loose RGB ball of the concept color:
    the 'did the concept appear' number for before/after."""
    from sdxl_training_improvements_tpu_torch.images import read_rgb
    return _color_fraction(read_rgb(png_path).astype(np.float32), color)


# ------------------------------------------------------------ vae pretrain

def seeded_vae(seed: int, device):
    """The tiny AutoencoderKL, fp32, weights from a generator seeded with
    ``seed`` on ``device`` (``models/sdxl.py``'s init)."""
    from sdxl_training_improvements_tpu_torch.models.sdxl import _materialize
    from sdxl_training_improvements_tpu_torch.models.vae import (
        AutoencoderKL, VAEConfig)
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig.tiny())
    return _materialize(vae, torch.float32, device,
                        torch.Generator(device=device).manual_seed(seed))


def vae_loss(vae, px: torch.Tensor, noise: torch.Tensor):
    """(loss, mse) of JAX's ``pretrain_vae`` closure: the reconstruction
    of a sampled latent, + 1e-4 KL, + 0.1 (std(mean * scaling) - 1)^2,
    which pins the scaled latents' std to 1 as SDXL-base's published VAE
    does for its scaling factor."""
    sf = vae.config.scaling_factor
    mean, logvar = vae.moments(px)
    z = mean + torch.exp(0.5 * logvar) * noise
    recon = vae.decode(z * sf)
    mse = (recon - px).square().mean()
    kl = 0.5 * (mean.square() + logvar.exp() - 1 - logvar).mean()
    scale_pen = ((mean * sf).std(correction=0) - 1.0).square()
    return mse + 1e-4 * kl + 0.1 * scale_pen, mse


def pretrain_vae(img_dir: Path, steps: int, batch: int, lr: float,
                 seed: int, log: Callable, device="cuda",
                 curve_every: int = 100):
    """Reconstruction-pretrain the tiny VAE (Adam: the port's plain AdamW
    at weight decay 0, optax.adam's arithmetic) so that diffusion trains
    in a latent space whose decoder draws real images (the role
    SDXL-base's published VAE plays).  Batches from ``default_rng(seed)``
    as JAX's; the sample's noise from a generator seeded ``seed + 1``;
    on a card with cuDNN's deterministic algorithms, as the trainer
    trains, so that a rerun repeats the codec.  The curve holds every
    ``curve_every``-th step's batch mse (JAX's: every 100th) and the
    last."""
    from sdxl_training_improvements_tpu_torch.images import read_rgb
    from sdxl_training_improvements_tpu_torch.training.loop import (
        deterministic_convolutions)
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        AdamW)
    dev = torch.device(device)
    paths = sorted(img_dir.glob("*.png"))
    imgs = np.stack([read_rgb(p).astype(np.float32) for p in paths])
    imgs = torch.from_numpy(np.transpose(imgs / 127.5 - 1.0, (0, 3, 1, 2))
                            ).to(dev)
    vae = seeded_vae(seed, dev)
    params = dict(vae.named_parameters())
    opt = AdamW(lr, weight_decay=0.0)
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed)
    f = vae.config.downscale_factor
    latent = (batch, vae.config.latent_channels, imgs.shape[2] // f,
              imgs.shape[3] // f)
    curve = []
    t0 = time.perf_counter()
    with deterministic_convolutions(dev):
        for i in range(steps):
            idx = torch.from_numpy(rng.integers(0, len(imgs), batch)).to(dev)
            px = imgs[idx]
            noise = torch.randn(latent, generator=gen, device=dev)
            loss, mse = vae_loss(vae, px, noise)
            mse = mse.detach()
            grads = torch.autograd.grad(loss, list(params.values()))
            deltas, state = opt.update(dict(zip(params, grads)), state,
                                       params)
            with torch.no_grad():
                for k, p in params.items():
                    p.add_(deltas[k])
            if i % curve_every == 0 or i == steps - 1:
                curve.append({"step": i, "mse": float(mse)})
                log(f"  vae step {i}: recon mse {float(mse):.5f}")
    log(f"  vae pretrain: {steps} steps in {time.perf_counter()-t0:.0f}s, "
        f"final mse {curve[-1]['mse']:.5f}")
    return vae, curve


def vae_recon_check(vae, concept, log):
    """Round-trip a fresh image of ``concept`` through the trained VAE:
    recon mse and the concept-colour pixel fraction (the codec can
    represent the held-out concept, which the LoRA stage depends on)."""
    color, shape = concept
    img = _draw(color, shape, np.random.default_rng(123))
    dev = next(vae.parameters()).device
    px = torch.from_numpy(np.transpose(
        img.astype(np.float32) / 127.5 - 1.0, (2, 0, 1))[None]).to(dev)
    with torch.no_grad():
        mean, _ = vae.moments(px)
        recon = vae.decode(mean * vae.config.scaling_factor)
    recon = recon.float().cpu().numpy()
    mse = float(np.mean(np.square(recon - px.cpu().numpy())))
    arr = np.clip((np.transpose(recon[0], (1, 2, 0)) + 1.0) * 127.5, 0, 255)
    frac = _color_fraction(arr, color)
    src = _color_fraction(img.astype(np.float32), color)
    log(f"  vae held-out '{color} {shape}' recon: mse {mse:.5f}, "
        f"{color} pixel fraction {frac:.4f} (source {src:.4f})")
    return {"concept": f"a {color} {shape}", "recon_mse": mse,
            "recon_color_fraction": frac, "source_color_fraction": src}


# ------------------------------------------------------------- config glue

def demo_config(data_dir: Path, *, batch: int, epochs: int, lr: float,
                out_label: str, seed: int = 0, image_size: int = 64,
                empty_prompts: float = 0.1):
    """JAX's ``demo_config`` on the port's ``Config``: the tiny model,
    flow matching (an O(1) loss from random init; v-prediction's targets
    blow up at the small-sigma end), fp32, plain AdamW, 10% empty
    captions so that guidance has a trained unconditional branch."""
    from sdxl_training_improvements_tpu_torch.config import Config
    cfg = Config()
    cfg.training.proportion_empty_prompts = empty_prompts
    cfg.model.model_type = "sdxl_tiny"
    cfg.training.method = "flow_matching"
    cfg.data.train_data_dir = [str(data_dir)]
    cfg.data.image_size = image_size
    cfg.data.random_flip = False  # shapes are orientation-specific
    cfg.training.batch_size = batch
    cfg.training.gradient_accumulation_steps = 1
    cfg.training.num_epochs = epochs
    cfg.training.mixed_precision = "no"
    cfg.training.save_every = 0
    cfg.training.save_best = False  # few-batch epochs: export final only
    cfg.training.seed = seed
    cfg.training.num_inference_steps = 40
    cfg.optimizer.optimizer_type = "adamw"
    cfg.optimizer.learning_rate = lr
    cfg.global_config.cache.cache_dir = str(WORK / f"cache_{out_label}")
    cfg.global_config.image.supported_dims = [[image_size, image_size]]
    cfg.global_config.image.min_size = [image_size // 2, image_size // 2]
    cfg.global_config.image.max_size = [image_size * 2, image_size * 2]
    cfg.global_config.logging.log_dir = str(WORK / f"logs_{out_label}")
    cfg.global_config.logging.log_every = 10
    return cfg


def full_scale_config(data_dir: Path, steps: int, image_size: int):
    """JAX's ``stage_full_scale`` config: ``Config()``'s SDXL defaults
    (ZTSNR, 1024 buckets), flow matching, batch 1, ``max_steps`` the cap,
    ``adamw_bf16`` at 1e-4 over LoRA rank 16, seeded weights."""
    from sdxl_training_improvements_tpu_torch.config import Config
    cfg = Config()
    cfg.training.method = "flow_matching"
    cfg.data.train_data_dir = [str(data_dir)]
    cfg.data.image_size = image_size
    cfg.training.batch_size = 1
    cfg.training.gradient_accumulation_steps = 1
    cfg.training.num_epochs = 10_000  # max_steps is the cap
    cfg.training.max_steps = steps
    cfg.training.save_every = 0
    cfg.training.save_best = False
    cfg.training.seed = 0
    cfg.optimizer.optimizer_type = "adamw_bf16"
    cfg.optimizer.learning_rate = 1e-4  # LoRA-only lr
    cfg.training.lora.enabled = True
    cfg.training.lora.rank = 16
    cfg.global_config.cache.cache_dir = str(WORK / "cache_full")
    cfg.global_config.logging.log_dir = str(WORK / "logs_full")
    cfg.global_config.logging.log_every = 10
    cfg.model.pretrained_model_name = "none"  # seeded weights
    return cfg


def run_trainer(cfg, out_dir: Path, log, device="cuda", model=None):
    """The real orchestration path (``training.loop.SDXLTrainer``): returns
    (trainer, the logged losses, train seconds); the last step's metrics
    are ``trainer.final_metrics``."""
    from sdxl_training_improvements_tpu_torch.training.loop import (
        SDXLTrainer)
    trainer = SDXLTrainer(cfg, model=model, output_dir=str(out_dir),
                          device=device)
    # the logger registry is process-wide: a second stage in the same
    # process gets the same tracker, so slice off earlier stages' history
    trainer.logger.metrics.keep_history = True
    start = len(trainer.logger.metrics.get_history("loss"))
    trainer.prepare_data()
    t0 = time.perf_counter()
    trainer.final_metrics = trainer.train()
    wall = time.perf_counter() - t0
    hist = trainer.logger.metrics.get_history("loss")[start:]
    log(f"  {len(hist)} logged losses over {wall:.0f}s; "
        f"first {hist[0]:.4f} -> last {hist[-1]:.4f}" if hist else
        f"  trained in {wall:.0f}s (no loss history)")
    return trainer, hist, wall


def sample(ckpt: Path, prompts, out_dir: Path, *, tiny: bool, size: int,
           steps: int = 40, seed: int = 7, seeds=None,
           guidance: float = 2.0, device: str = "cuda"):
    """Generate through the real CLI entry (``generate.main``); ``seeds``
    draws one batch a seed into per-seed subdirectories."""
    from sdxl_training_improvements_tpu_torch.generate import main as gen
    pngs = []
    for s in (seeds if seeds is not None else [seed]):
        sub = out_dir if seeds is None else out_dir / f"seed{s}"
        argv = ["--model", str(ckpt), "--out", str(sub),
                "--height", str(size), "--width", str(size),
                "--steps", str(steps), "--seed", str(s),
                "--guidance", str(guidance), "--device", str(device)]
        if tiny:
            argv.append("--tiny")
        for p in prompts:
            argv += ["--prompt", p]
        rc = gen(argv)
        if rc != 0:
            raise RuntimeError(f"generate.main returned {rc}")
        pngs += sorted(sub.glob("*.png"))
    return pngs


def _mean(values) -> Optional[float]:
    return float(np.mean(values)) if len(values) else None


def _where(device) -> dict:
    return {"device": str(device), "card": card(device),
            "torch": torch.__version__}


# ------------------------------------------------------------------ stages

GUIDANCE_SWEEP = (1.0, 2.0, 5.0)  # recorded diagnostics; scores use the max
SEEDS = (7, 11, 23, 42)
MARGIN = 0.03


def stage_pretrain(log, fast: bool = False, n_per: int = None,
                   epochs: int = None, device: str = "cuda"):
    """Shapes dataset -> VAE pretrain -> base diffusion train -> diffusers
    checkpoint at ``WORK/base/final_checkpoint``."""
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.training import (
        checkpoints as C)
    dev = require_device(device)
    n_per = n_per or (16 if fast else 64)
    epochs = epochs or (20 if fast else 400)
    data_dir = WORK / "data_base"
    n = make_dataset(data_dir, BASE_CONCEPTS, n_per=n_per, seed=0)
    log(f"base dataset: {n} images x 3 concepts at {data_dir}")

    # the VAE plays SDXL-base's published VAE: a codec of every colour,
    # the held-out green included; only the diffusion model holds it out
    vae_data = WORK / "data_vae"
    n_vae = make_dataset(vae_data, BASE_CONCEPTS + [NEW_CONCEPT],
                         n_per=16 if fast else 48, seed=5)
    log(f"vae codec dataset: {n_vae} images x 4 concepts (incl. held-out)")
    vae, vae_curve = pretrain_vae(vae_data, steps=200 if fast else 1500,
                                  batch=16, lr=2e-3, seed=0, log=log,
                                  device=dev)
    green_recon = vae_recon_check(vae, NEW_CONCEPT, log)

    # the trained VAE with a seeded UNet and CLIPs, exported as the
    # "pretrained" start so that the trainer's import path runs
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(0))
    model.vae = vae.eval()
    init_ckpt = WORK / "base_init"
    cfg = demo_config(data_dir, batch=16, epochs=epochs, lr=4e-4,
                      out_label="base")
    C.export_diffusers(init_ckpt, C.components(model), cfg,
                       unet_config=model.unet_config)
    del model
    cfg.model.pretrained_model_name = str(init_ckpt)
    trainer, hist, wall = run_trainer(cfg, WORK / "base", log, device=dev)
    del trainer
    ckpt = WORK / "base" / "final_checkpoint"
    if not ckpt.exists():
        raise RuntimeError(f"no final checkpoint at {ckpt}")

    # the base must draw its trained concepts; per concept the max over
    # the guidance sweep
    sdir = ART / "samples_base"
    prompts = [f"a {c} {s}" for c, s in BASE_CONCEPTS]
    sweep = {}
    for g in GUIDANCE_SWEEP:
        pngs = sample(ckpt, prompts, sdir / f"g{g:g}", tiny=True, size=64,
                      guidance=g, device=device)
        # generate.py writes 000.png, 001.png, ... in prompt order
        sweep[f"g{g:g}"] = {
            prompts[i]: concept_score(png, BASE_CONCEPTS[i][0])
            for i, png in enumerate(pngs[:len(prompts)])}
        log(f"  base concept scores @ guidance {g:g}: {sweep[f'g{g:g}']}")
    scores = {p: max(sweep[k][p] for k in sweep) for p in prompts}
    log(f"base concept scores (max over guidance): {scores}")
    out = {
        "dataset_images": n,
        "epochs": epochs,
        "vae_recon_curve": vae_curve,
        "diffusion_loss_first10_mean": _mean(hist[:10]),
        "diffusion_loss_last10_mean": _mean(hist[-10:]),
        "diffusion_steps_logged": len(hist),
        "train_wall_seconds": round(wall, 1),
        "base_concept_scores": scores,
        "base_concept_scores_by_guidance": sweep,
        "vae_heldout_recon": green_recon,
        "loss_history": hist,
        "fast": fast,
        **_where(dev),
    }
    ART.mkdir(parents=True, exist_ok=True)
    (ART / "pretrain.json").write_text(json.dumps(out, indent=1))
    log(f"pretrain stage done -> {ART / 'pretrain.json'}")
    return ckpt


def gate(before: float, after: float, margin: float = MARGIN) -> bool:
    """JAX's concept gate: the fine-tune must teach the concept, beating
    the base's own hallucination rate decisively."""
    return after > max(before + margin, margin) and after > 2.0 * before


def stage_lora(log, fast: bool = False, n_per: int = None,
               epochs: int = None, enforce: bool = True,
               device: str = "cuda"):
    """LoRA fine-tune of the held-out concept from the pretrained
    checkpoint: before/after samples, concept scores, the loss curve and
    the gate (which raises when it fails, unless ``enforce`` is off)."""
    dev = require_device(device)
    base_ckpt = WORK / "base" / "final_checkpoint"
    if not base_ckpt.exists():
        raise SystemExit("run --stage pretrain first (no base checkpoint)")
    n_per = n_per or (16 if fast else 64)
    epochs = epochs or (30 if fast else 900)
    color, shape = NEW_CONCEPT
    data_dir = WORK / "data_new"
    n = make_dataset(data_dir, [NEW_CONCEPT], n_per=n_per, seed=1)
    prompt = f"a {color} {shape}"
    log(f"new-concept dataset: {n} images of '{prompt}'")

    def score_sweep(ckpt, out_dir):
        """Mean over seeds at each guidance, max over guidance, and the
        table of every cell (with each guidance's minimum over seeds)."""
        table = {}
        for g in GUIDANCE_SWEEP:
            pngs = sample(ckpt, [prompt], out_dir / f"g{g:g}", tiny=True,
                          size=64, seeds=list(SEEDS), guidance=g,
                          device=device)
            table[f"g{g:g}"] = [concept_score(p, color) for p in pngs]
        best = max(float(np.mean(v)) for v in table.values())
        return best, table

    s_before, before_table = score_sweep(base_ckpt,
                                         ART / "samples_before_lora")
    cfg = demo_config(data_dir, batch=16, epochs=epochs, lr=1e-3,
                      out_label="lora", seed=3)
    cfg.model.pretrained_model_name = str(base_ckpt)
    cfg.training.lora.enabled = True
    cfg.training.lora.rank = 16
    cfg.training.lora.alpha = 1.0
    # attention, MLP and conv adapters: in a tiny UNet the frozen convs
    # own the colour statistics
    cfg.training.lora.targets = [
        r"attn\d/(to_q|to_k|to_v|to_out_0)", r"ff/(net_0/proj|net_2)",
        r"conv"]
    trainer, hist, wall = run_trainer(cfg, WORK / "lora", log, device=dev)
    del trainer
    ckpt = WORK / "lora" / "final_checkpoint"
    if not (ckpt / "pytorch_lora_weights.safetensors").exists():
        raise RuntimeError(f"{ckpt}: no LoRA adapter exported")

    # reload the export from disk and sample the same prompts and seeds
    s_after, after_table = score_sweep(ckpt, ART / "samples_after_lora")
    log(f"concept score '{prompt}': before {s_before:.4f} -> "
        f"after {s_after:.4f}")
    passed = gate(s_before, s_after)

    def minima(table):
        return {g: min(v) for g, v in table.items()}
    out = {
        "concept": prompt,
        "dataset_images": n,
        "lora_rank": cfg.training.lora.rank,
        "epochs": epochs,
        "loss_first10_mean": _mean(hist[:10]),
        "loss_last10_mean": _mean(hist[-10:]),
        "steps_logged": len(hist),
        "train_wall_seconds": round(wall, 1),
        "concept_score_before": s_before,
        "concept_score_after": s_after,
        "concept_scores_by_guidance": {"before": before_table,
                                       "after": after_table},
        # recorded, not gated (JAX's gate is on the means)
        "concept_score_min_over_seeds": {"before": minima(before_table),
                                         "after": minima(after_table)},
        "concept_gate": {
            "margin": MARGIN,
            "rule": "mean-over-seeds max-over-guidance score; pass iff "
                    "after > max(before+margin, margin) and after > "
                    "2*before",
            "passed": bool(passed)},
        "loss_history": hist,
        "fast": fast,
        **_where(dev),
    }
    ART.mkdir(parents=True, exist_ok=True)
    (ART / "lora.json").write_text(json.dumps(out, indent=1))
    log(f"lora stage done -> {ART / 'lora.json'}")
    if enforce and not passed:
        raise SystemExit(
            f"CONCEPT GATE FAILED: after {s_after:.4f} vs before "
            f"{s_before:.4f} (needs > before + {MARGIN}, > {MARGIN}, and "
            "> 2x before): the LoRA fine-tune did not teach the held-out "
            "concept (artifacts recorded anyway)")
    log(f"concept gate {'PASSED' if passed else 'FAILED'} (after "
        f"{s_after:.4f}, before {s_before:.4f})")
    return out


def stage_full_scale(log, steps: int = 300, image_size: int = 1024,
                     n_images: int = 16, device: str = "cuda",
                     out_name: Optional[str] = "full_scale.json") -> dict:
    """The scale proof: LoRA over the full 2.567B-parameter UNet at
    ``image_size``^2 through the real trainer, seeded weights, then the
    export reloaded through ``SDXLPipeline.from_pretrained``.  Writes
    ``ART/out_name`` (None: no file) and returns the record."""
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    dev = require_device(device)
    on_card = dev.type == "cuda"
    data_dir = WORK / "data_full"
    n = make_dataset(data_dir, BASE_CONCEPTS + [NEW_CONCEPT],
                     n_per=max(1, n_images // 4), seed=2, size=image_size)
    log(f"full-scale dataset: {n} images at {image_size}^2")
    cfg = full_scale_config(data_dir, steps, image_size)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer, hist, wall = run_trainer(cfg, WORK / "full", log, device=dev)
    ckpt = WORK / "full" / "final_checkpoint"
    final_loss = trainer.final_metrics["loss"]
    n_unet = sum(p.numel() for p in trainer.model.unet.parameters())
    n_lora = sum(p.numel() for p in trainer.state.params.values())
    mem = {}
    if on_card:
        free, total = torch.cuda.mem_get_info(dev)
        mem = {"peak_bytes_allocated": torch.cuda.max_memory_allocated(dev),
               "bytes_allocated": torch.cuda.memory_allocated(dev),
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "free_bytes": free, "total_bytes": total}
    del trainer
    if on_card:
        torch.cuda.empty_cache()

    # the deployment round trip at full scale
    t1 = time.perf_counter()
    pipe = SDXLPipeline.from_pretrained(ckpt, device=dev)
    reloaded = sum(p.numel() for p in pipe.model.unet.parameters())
    if reloaded != n_unet:
        raise RuntimeError(f"reloaded UNet has {reloaded} parameters, "
                           f"trained {n_unet}")
    reload_s = time.perf_counter() - t1
    log(f"full-scale checkpoint reloaded through SDXLPipeline "
        f"({reload_s:.1f} s)")
    del pipe
    if on_card:
        torch.cuda.empty_cache()
    logged_steps = [cfg.global_config.logging.log_every * (i + 1)
                    for i in range(len(hist))]
    out = {
        "unet_params": int(n_unet),
        "lora_trainable_params": int(n_lora),
        "steps": steps,
        "image_size": image_size,
        "dataset_images": n,
        "final_loss": final_loss,
        "loss_first10_mean": _mean(hist[:10]),
        "loss_last10_mean": _mean(hist[-10:]),
        "loss_history": hist,
        "loss_history_steps": logged_steps,
        "train_wall_seconds": round(wall, 1),
        "seconds_per_step": wall / steps,
        "total_wall_seconds": round(time.perf_counter() - t0, 1),
        "samples_per_sec": steps * cfg.training.batch_size / wall,
        "reload_seconds": round(reload_s, 1),
        "reloaded_through": "SDXLPipeline.from_pretrained",
        "device_memory": mem,
        "weights": "seeded (no pretrained SDXL in the repository; the "
                   "mechanics are a real fine-tune's)",
        **_where(dev),
    }
    if out_name:
        ART.mkdir(parents=True, exist_ok=True)
        (ART / out_name).write_text(json.dumps(out, indent=1))
        log(f"full-scale stage done -> {ART / out_name}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", default="all",
                    choices=["pretrain", "lora", "all", "full-scale"])
    ap.add_argument("--fast", action="store_true",
                    help="tiny step counts (a smoke, not evidence)")
    ap.add_argument("--steps", type=int, default=300,
                    help="full-scale stage step count")
    ap.add_argument("--image-size", type=int, default=1024)
    ap.add_argument("--n-per", type=int, default=None,
                    help="images per concept (experiment override)")
    ap.add_argument("--epochs-base", type=int, default=None)
    ap.add_argument("--epochs-lora", type=int, default=None)
    ap.add_argument("--no-gate", action="store_true",
                    help="record the concept score without failing on it "
                         "(experiment runs only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    def log(msg):
        print(f"[finetune_demo] {msg}", flush=True)

    WORK.mkdir(parents=True, exist_ok=True)
    ART.mkdir(parents=True, exist_ok=True)
    if args.stage in ("pretrain", "all"):
        stage_pretrain(log, fast=args.fast, n_per=args.n_per,
                       epochs=args.epochs_base, device=args.device)
    if args.stage in ("lora", "all"):
        stage_lora(log, fast=args.fast, n_per=args.n_per,
                   epochs=args.epochs_lora, enforce=not args.no_gate,
                   device=args.device)
    if args.stage == "full-scale":
        stage_full_scale(log, steps=args.steps, image_size=args.image_size,
                         device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
