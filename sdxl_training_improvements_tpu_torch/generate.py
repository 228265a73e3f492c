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

    # write a text-to-image artifact (meta.json), then run it: its CUDA
    # graphs are captured at load (see aot.py)
    ... --export-aot artifacts/sdxl_28step
    ... --aot artifacts/sdxl_28step

    # over several cards, one process each: the UNet megatron-split over
    # the tensor axis, the CFG rows over data x fsdp; rank 0 writes
    torchrun --nproc-per-node 2 -m sdxl_training_improvements_tpu_torch.\
        generate --model ... --prompt ... --mesh 1,1,2

``--model`` is a diffusers-layout directory, such as
``training.checkpoints.export_diffusers`` writes.  Images are written as
PNG by ``png.py``; ``--init`` and ``--mask`` are read by ``images.py`` (no
Pillow: JPEG or PNG, to the bits Pillow's ``convert("RGB")`` and
``convert("L")`` give) or as ``.npy`` arrays (HxWx3 uint8; HxW, nonzero =
repaint).  An init image or
mask of another size is resized to ``--width`` x ``--height`` as JAX's
Pillow path does (Lanczos; a mask nearest, before its 127 threshold).
``--device cpu`` runs on the CPU.  ``--mesh DATA,FSDP,TENSOR`` runs one
process a card, started by torchrun or by JAX's env triple
(``COORDINATOR_ADDRESS``, ``SDXL_NUM_PROCESSES``, ``SDXL_PROCESS_ID``), as
``main.py`` does (``parallel/mesh.py`` ``initialize_multihost``: rank r
on ``cuda:LOCAL_RANK``, gloo ranks with ``--device cpu``); every rank
samples and rank 0 writes the images.  ``--aot`` refuses ``--mesh``, as
JAX's does.
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
                   help="serve over a mesh of ranks, one process a card "
                        "(torchrun), e.g. 1,1,2: the UNet is megatron-"
                        "split over the tensor axis and the CFG batch "
                        "sharded over data x fsdp")
    p.add_argument("--init", action="append", default=None, metavar="IMAGE",
                   help="img2img init image, JPEG, PNG or .npy (repeat to "
                        "match --prompt count; resized to --height x "
                        "--width)")
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
                   help="instead of sampling, write the text2img artifact "
                        "to DIR: batch = number of --prompt flags, "
                        "resolution/steps/sampler from the other flags; "
                        "its CUDA graphs are captured where it is loaded "
                        "(see aot.py)")
    p.add_argument("--aot-platforms", default="cuda,cpu",
                   help="comma-separated device types the artifact may "
                        "run on (with --export-aot)")
    p.add_argument("--aot", default=None, metavar="DIR",
                   help="run text2img through an artifact (with --model "
                        "supplying the weights); incompatible with "
                        "img2img/inpaint/refiner/--mesh")
    p.add_argument("--device", default="cuda",
                   help="torch device (the card unless told otherwise)")
    return p


def _load_images(paths, height, width):
    from sdxl_training_improvements_tpu_torch.images import read_rgb
    from sdxl_training_improvements_tpu_torch.png import (
        resize_lanczos, to_rgb)
    out = []
    for path in paths:
        a = np.load(path) if Path(path).suffix == ".npy" else read_rgb(path)
        if a.dtype != np.uint8:
            raise SystemExit(f"{path}: expected uint8 pixels, got {a.dtype}")
        a = to_rgb(a)
        if a.shape[:2] != (height, width):
            a = resize_lanczos(a, width, height)
        out.append(a)
    return out


def _load_masks(paths, height, width):
    from sdxl_training_improvements_tpu_torch.images import read_gray
    from sdxl_training_improvements_tpu_torch.png import (
        resize_nearest, to_gray)
    out = []
    for path in paths:
        if Path(path).suffix == ".npy":  # nonzero = repaint
            m = to_gray((np.load(path) != 0).astype(np.uint8) * 255)
        else:
            m = read_gray(path)
        # white = repaint: luma > 127 after the nearest resize
        if m.shape != (height, width):
            m = resize_nearest(m, width, height)
        out.append((m > 127).astype(np.uint8))
    return out


def _run_aot(args, argv) -> int:
    """``--aot``: text to image through the artifact; a flag passed
    explicitly that disagrees with its static settings exits."""
    from sdxl_training_improvements_tpu_torch.aot import (
        AOTPipeline, read_meta)
    if args.init or args.mask or args.refiner or args.mesh:
        raise SystemExit("--aot serves the exported text2img program "
                         "only (no img2img/inpaint/refiner/--mesh)")
    # "explicitly passed" by re-parsing argv with every default SUPPRESSed
    # (absent flags then do not appear), not by comparing with the
    # parser's defaults: the default value passed against an artifact
    # made with another one conflicts too
    sentinel = build_parser()
    for action in sentinel._actions:
        action.default = argparse.SUPPRESS
        action.required = False
    explicit = vars(sentinel.parse_args(argv))
    meta = read_meta(args.aot)
    static = {"steps": "num_inference_steps", "height": "height",
              "width": "width", "sampler": "sampler",
              "deep_cache": "deep_cache"}
    for flag, key in static.items():
        passed, baked = getattr(args, flag), meta.get(key)
        if flag in explicit and passed != baked:
            raise SystemExit(
                f"--{flag.replace('_', '-')}={passed} conflicts with the "
                f"AOT artifact ({key}={baked} is static in the exported "
                "program); drop the flag or re-export")
    aot = AOTPipeline.from_pretrained(args.aot, args.model, tiny=args.tiny,
                                      device=args.device)
    _write(aot(args.prompt, negative_prompts=args.negative, seed=args.seed,
               guidance_scale=args.guidance), args.out)
    return 0


def _write(images, out) -> None:
    """The images as ``out/NNN.png``, each path printed."""
    from sdxl_training_improvements_tpu_torch.png import write_png
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(images):
        path = out_dir / f"{i:03d}.png"
        write_png(path, img)
        print(path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline

    if args.mask and not args.init:
        raise SystemExit("--mask requires --init (the image to repaint)")
    if args.aot:
        return _run_aot(args, argv)
    mesh, device = _mesh(args.mesh, args.device)
    method = None if args.method == "auto" else args.method
    common = dict(tiny=args.tiny, sampler=args.sampler,
                  deep_cache=args.deep_cache, device=device, mesh=mesh)
    pipe = SDXLPipeline.from_pretrained(args.model, method=method, **common)
    print(f"sampler method: {pipe.method} ({args.sampler}"
          + (f", deep-cache {args.deep_cache}" if args.deep_cache > 1
             else "") + ")")
    if args.export_aot:
        from sdxl_training_improvements_tpu_torch.aot import export_text2img
        art = export_text2img(
            pipe, args.export_aot, batch=len(args.prompt),
            height=args.height, width=args.width,
            num_inference_steps=args.steps, guidance_scale=args.guidance,
            aesthetic_score=args.aesthetic_score,
            platforms=tuple(s for s in args.aot_platforms.split(",") if s))
        print(f"AOT artifact written to {art}")
        return 0
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
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    if M.is_main_process():
        _write(images, args.out)
    return 0


def _mesh(spec, device):
    """(the mesh of ``--mesh``, or None, and this rank's device): joins the
    cluster the environment names; a one-rank mesh without one serves as
    no mesh does."""
    if not spec:
        return None, device
    import math

    import torch

    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    try:
        shape = [int(v) for v in spec.split(",")]
        if len(shape) != 3:
            raise ValueError
    except ValueError:
        raise SystemExit(f"--mesh wants 3 comma-separated sizes "
                         f"(data,fsdp,tensor), got {spec!r}")
    kind = torch.device(device).type
    M.initialize_multihost(kind)
    if not torch.distributed.is_initialized():
        if math.prod(shape) == 1:
            return None, device
        raise SystemExit(f"--mesh {spec}: {math.prod(shape)} ranks, but no "
                         "cluster is named; start one process a card with "
                         "torchrun (or JAX's env triple)")
    if kind == "cuda" and M.process_count() > 1:
        device = f"cuda:{M.local_rank()}"
    try:
        return M.create_mesh(shape, device_type=kind), device
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}")


def cli() -> None:
    sys.exit(main())


if __name__ == "__main__":
    cli()
