"""Image-generation CLI over the port's ``SDXLPipeline``.

The flags and ``main(argv) -> int`` of ``sdxl_training_improvements_tpu/
generate.py``:

    # text -> image, on the card
    python -m sdxl_training_improvements_tpu_torch.generate \\
        --model outputs/final_checkpoint \\
        --prompt "a photograph of an astronaut riding a horse" \\
        --steps 28 --guidance 5.0 --out samples/

    # img2img (edit an existing image)
    ... --init photo.png --strength 0.35

    # inpainting (9-channel inpainting checkpoint)
    ... --init photo.png --mask mask.png

    # two-stage base -> refiner ensemble
    ... --refiner /path/to/refiner_checkpoint --denoising-frac 0.8

``--model`` is a diffusers-layout directory, such as
``training.checkpoints.export_diffusers`` writes.  Images are written and
read as PNG by ``png.py`` (no Pillow); ``--init`` and ``--mask`` also take
``.npy`` arrays (HxWx3 uint8; HxW, nonzero = repaint).  An init image must
be ``--height`` x ``--width``: resizing is not ported (ROADMAP queue 1,
item 12).  ``--device cpu`` runs on the CPU.  Not ported: ``--mesh``
(ROADMAP queue 1, item 14) and ``--aot`` / ``--export-aot`` (item 5, the
CUDA-graph capture of ``aot.py``).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdxl-torch-generate",
        description="Sample images from a diffusers-layout SDXL checkpoint")
    p.add_argument("--model", required=True,
                   help="diffusers-layout checkpoint directory")
    p.add_argument("--prompt", action="append", required=True,
                   help="prompt (repeatable for a batch)")
    p.add_argument("--negative", action="append", default=None,
                   help="negative prompt (repeat to match --prompt count)")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--steps", type=int, default=28)
    p.add_argument("--guidance", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--method", choices=["auto", "ddpm", "flow_matching"],
                   default="auto",
                   help="sampler family; auto reads training.method from "
                        "the checkpoint's config.json")
    p.add_argument("--out", default="samples")
    p.add_argument("--tiny", action="store_true",
                   help="tiny test topology (CI smoke)")
    p.add_argument("--mesh", default=None, metavar="DATA,FSDP,TENSOR",
                   help="not ported: serving over several cards")
    p.add_argument("--init", action="append", default=None, metavar="IMAGE",
                   help="img2img init image, PNG or .npy (repeat to match "
                        "--prompt count; must be --height x --width)")
    p.add_argument("--strength", type=float, default=None,
                   help="edit strength in (0, 1]; defaults to 0.35 for "
                        "img2img, 1.0 (full repaint) for inpainting")
    p.add_argument("--mask", action="append", default=None, metavar="IMAGE",
                   help="inpainting mask (white = repaint); requires --init "
                        "and a 9-channel inpainting checkpoint")
    p.add_argument("--refiner", default=None, metavar="DIR",
                   help="refiner checkpoint for the two-stage "
                        "base->refiner ensemble")
    p.add_argument("--denoising-frac", type=float, default=0.8,
                   help="fraction of the sigma walk done by the base model "
                        "before the refiner takes over")
    p.add_argument("--aesthetic-score", type=float, default=6.0)
    p.add_argument("--sampler", choices=["euler", "dpmpp_2m"],
                   default="euler",
                   help="sigma-space integration rule: euler (reference "
                        "ZTSNR walk) or dpmpp_2m (2nd-order multistep; "
                        "try --steps 14)")
    p.add_argument("--deep-cache", type=int, default=1, metavar="K",
                   help="DeepCache interval: refresh the deep UNet feature "
                        "every K steps and run only the shallow stages "
                        "between (1 = off, 2-3 = typical)")
    p.add_argument("--export-aot", default=None, metavar="DIR",
                   help="not ported: serialize the text2img program")
    p.add_argument("--aot-platforms", default="tpu,cpu",
                   help="not ported (with --export-aot)")
    p.add_argument("--aot", default=None, metavar="DIR",
                   help="not ported: run an exported program")
    p.add_argument("--device", default="cuda",
                   help="torch device (the card unless told otherwise)")
    return p


def _read(path) -> np.ndarray:
    from sdxl_training_improvements_tpu_torch.png import read_png
    path = Path(path)
    return np.load(path) if path.suffix == ".npy" else read_png(path)


def _check_size(a: np.ndarray, path, height: int, width: int) -> None:
    if a.shape[:2] != (height, width):
        raise SystemExit(
            f"{path}: {a.shape[1]}x{a.shape[0]} is not --width x --height "
            f"{width}x{height}; resizing is not ported (ROADMAP queue 1, "
            "item 12): resize it first")


def _load_images(paths, height, width):
    from sdxl_training_improvements_tpu_torch.png import to_rgb
    out = []
    for path in paths:
        a = _read(path)
        if a.dtype != np.uint8:
            raise SystemExit(f"{path}: expected uint8 pixels, got {a.dtype}")
        a = to_rgb(a)
        _check_size(a, path, height, width)
        out.append(a)
    return out


def _load_masks(paths, height, width):
    from sdxl_training_improvements_tpu_torch.png import to_gray
    out = []
    for path in paths:
        a = _read(path)
        # a PNG mask is white = repaint (luma > 127); an .npy one nonzero
        m = ((to_gray(a) > 127) if Path(path).suffix != ".npy"
             else (a != 0)).astype(np.uint8)
        _check_size(m, path, height, width)
        out.append(m)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    from sdxl_training_improvements_tpu_torch.png import write_png

    if args.mesh:
        raise SystemExit("--mesh: serving over several cards is not ported "
                         "(ROADMAP queue 1, item 14)")
    if args.aot or args.export_aot:
        raise SystemExit("--aot/--export-aot: not ported; their "
                         "counterpart is the CUDA-graph capture of "
                         "serve.py/aot.py (ROADMAP queue 1, item 5)")
    if args.mask and not args.init:
        raise SystemExit("--mask requires --init (the image to repaint)")
    method = None if args.method == "auto" else args.method
    common = dict(tiny=args.tiny, sampler=args.sampler,
                  deep_cache=args.deep_cache, device=args.device)
    pipe = SDXLPipeline.from_pretrained(args.model, method=method, **common)
    print(f"sampler method: {pipe.method} ({args.sampler}"
          + (f", deep-cache {args.deep_cache}" if args.deep_cache > 1
             else "") + ")")
    run = dict(num_inference_steps=args.steps, guidance_scale=args.guidance,
               seed=args.seed, negative_prompts=args.negative)
    if args.mask:
        inits = _load_images(args.init, args.height, args.width)
        masks = _load_masks(args.mask, args.height, args.width)
        images = pipe.inpaint(args.prompt, inits, masks,
                              strength=(1.0 if args.strength is None
                                        else args.strength), **run)
    elif args.init:
        inits = _load_images(args.init, args.height, args.width)
        images = pipe.img2img(args.prompt, images=inits,
                              strength=(0.35 if args.strength is None
                                        else args.strength),
                              aesthetic_score=args.aesthetic_score, **run)
    elif args.refiner:
        noisy = pipe(args.prompt, height=args.height, width=args.width,
                     denoising_end=args.denoising_frac, **run)
        del pipe
        refiner = SDXLPipeline.from_pretrained(args.refiner, **common)
        print(f"refining from denoising fraction {args.denoising_frac}")
        images = refiner.refine(args.prompt, noisy,
                                denoising_start=args.denoising_frac,
                                aesthetic_score=args.aesthetic_score, **run)
    else:
        images = pipe(args.prompt, height=args.height, width=args.width,
                      **run)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(images):
        path = out_dir / f"{i:03d}.png"
        write_png(path, img)
        print(path)
    return 0


def cli() -> None:
    sys.exit(main())


if __name__ == "__main__":
    cli()
