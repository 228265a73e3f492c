"""The latent-cache precompute's rate (the BASELINE "latent-cache
imgs/sec" metric), serial against the three-stage pipeline.

Port of ``tools/bench_precompute.py``: writes N seeded noise images,
runs ``AspectBucketDataset.precompute`` with ``serial=True`` (the
reference's decode -> encode -> write loop) and with the pipeline
(``num_workers`` decode threads, the encoder on the main thread, a writer
pool), and reports images/s of each and the stage seconds.  The images
are PNGs written by the port's ``png.py`` (the JAX tool writes JPEGs
with Pillow, which the card's machine lacks).  Each arm's VAE sample
draws come from a generator seeded with 0, so both arms write the same
cache: the JSON holds each cache's digest and whether they are equal.

    python -m sdxl_training_improvements_tpu_torch.tools.bench_precompute \\
        --images 64 --size 512 [--real-vae] [--device cuda|cpu]
    python -m sdxl_training_improvements_tpu_torch.tools.bench_precompute \\
        --device cpu --images 64 --device-ms 40

The default VAE is a 4-stage miniature (16/16/32/32 channels: SDXL's 8x
reduction at a small width); ``--real-vae`` builds the full SDXL VAE
(seeded weights: the rate does not depend on them).  ``--device-ms F``
(CPU runs) stands in for an encode on a device: the encode stage sleeps
F ms a batch without holding the GIL and returns zeros, so the pipeline's
overlap shows even on a host of one core.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.tools import card, require_device


def make_images(root: Path, n: int, size: int) -> None:
    """``n`` noise PNGs from ``default_rng(0)``, every third half as
    wide, each with a caption file (JAX's draws)."""
    from sdxl_training_improvements_tpu_torch.png import write_png
    rng = np.random.default_rng(0)
    for i in range(n):
        w = size if i % 3 else max(64, size // 2)
        arr = rng.integers(0, 255, (size, w, 3), dtype=np.uint8)
        write_png(root / f"img{i:04d}.png", arr)
        (root / f"img{i:04d}.txt").write_text(f"test caption {i}, quality")


def _vae(real: bool, device: torch.device):
    from sdxl_training_improvements_tpu_torch.models.sdxl import _materialize
    from sdxl_training_improvements_tpu_torch.models.vae import (
        AutoencoderKL, VAEConfig)
    vcfg = VAEConfig.sdxl() if real else VAEConfig(
        block_out_channels=(16, 16, 32, 32), layers_per_block=1,
        norm_num_groups=8)
    with torch.device("meta"):
        vae = AutoencoderKL(vcfg)
    return _materialize(vae, torch.float32, device,
                        torch.Generator(device=device).manual_seed(0))


def cache_digest(cache, paths) -> str:
    """sha256 over every path's cached latents and time ids, in order."""
    h = hashlib.sha256()
    for p in paths:
        entry = cache.load_latents(cache.get_cache_key(p))
        if entry is None:
            raise ValueError(f"{p}: not in the cache")
        for k in ("vae_latents", "time_ids"):
            h.update(np.ascontiguousarray(entry[k]).tobytes())
    return h.hexdigest()


def run(n_images: int, size: int, workers: int, real_vae: bool,
        batch: int, device: str = "cuda", device_ms: float = 0.0,
        root: Optional[Path] = None) -> dict:
    """{"serial": stats, "parallel": stats} of the two precomputes (each
    with its cache's ``digest``), after one untimed warm-up run."""
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.data.buckets import (
        supported_dims_buckets)
    from sdxl_training_improvements_tpu_torch.data.cache import CacheManager
    from sdxl_training_improvements_tpu_torch.data.dataset import (
        AspectBucketDataset)
    from sdxl_training_improvements_tpu_torch.data.paths import (
        load_data_from_directory)

    dev = require_device(device)
    root = Path(root or tempfile.mkdtemp(prefix="precompute_bench_"))
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    make_images(img_dir, n_images, size)

    cfg = Config()
    cfg.data.train_data_dir = [str(img_dir)]
    cfg.global_config.image.supported_dims = [
        [size, size], [size // 2, size], [size, size // 2]]
    cfg.global_config.image.min_size = [64, 64]
    cfg.global_config.image.max_size = [size, size]
    cfg.global_config.image.target_size = [size, size]

    vae = _vae(real_vae, dev)
    gen = {}

    if device_ms:
        def enc_i(px):
            time.sleep(device_ms / 1e3)
            b, _, h, w = px.shape
            return np.zeros((b, 4, h // 8, w // 8), np.float32)
    else:
        def enc_i(px):
            with torch.no_grad():
                lat = vae.encode(torch.from_numpy(px).to(dev),
                                 generator=gen["g"])
            return lat.cpu().numpy()

    def enc_p(caps):
        return {"prompt_embeds": np.zeros((len(caps), 77, 64), np.float32),
                "pooled_prompt_embeds": np.zeros((len(caps), 32),
                                                 np.float32)}

    paths, captions = load_data_from_directory(cfg.data.train_data_dir)
    results = {}
    for label, kw in (("warm", dict(num_workers=2)),
                      ("serial", dict(serial=True)),
                      ("parallel", dict(num_workers=workers))):
        gen["g"] = torch.Generator(device=dev).manual_seed(0)
        cache_dir = root / f"cache_{label}"
        cm = CacheManager(cache_dir)
        ds = AspectBucketDataset(cfg, paths, captions, cm,
                                 buckets=supported_dims_buckets(cfg))
        ds.precompute(enc_i, enc_p, batch_size=batch, **kw)
        if label != "warm":
            results[label] = dict(ds.last_precompute_stats,
                                  digest=cache_digest(cm, paths))
        shutil.rmtree(cache_dir, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", type=int, default=64)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--real-vae", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--device-ms", type=float, default=0.0,
                   help="stand in for an encode on a device: sleep this "
                        "many ms a batch in the encode stage (host free)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    workers = args.workers or min(16, os.cpu_count() or 4)
    res = run(args.images, args.size, workers, args.real_vae, args.batch,
              device=args.device, device_ms=args.device_ms)
    speedup = (res["parallel"]["images_per_sec"]
               / max(res["serial"]["images_per_sec"], 1e-9))
    out = {
        "images": args.images, "size": args.size, "workers": workers,
        "batch": args.batch, "real_vae": args.real_vae,
        "device": args.device, "card": card(args.device),
        "device_ms": args.device_ms,
        "serial_imgs_per_sec": res["serial"]["images_per_sec"],
        "parallel_imgs_per_sec": res["parallel"]["images_per_sec"],
        "speedup": speedup,
        "caches_equal": res["serial"]["digest"] == res["parallel"]["digest"],
        "stages": {k: v for k, v in res["parallel"].items()
                   if k.startswith("stage_")},
        "stages_serial": {k: v for k, v in res["serial"].items()
                          if k.startswith("stage_")}}
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if out["caches_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
