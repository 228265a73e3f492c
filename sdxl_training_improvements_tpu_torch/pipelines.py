"""SDXL inference pipeline, in PyTorch.

Port of ``SDXLPipeline`` from ``sdxl_training_improvements_tpu/
pipelines.py``: text-to-image, img2img, inpainting (9-channel UNets) and
the base->refiner handoff, through the ZTSNR Karras-Euler or DPM++(2M)
sampler (``method="ddpm"``) or the flow-matching ODE, with DeepCache and
classifier-free guidance.  ``from_pretrained`` loads a diffusers-layout
checkpoint directory (the port's own safetensors reader); the UNet's
topology, the sampler family and the noise schedule follow what the
checkpoint declares.

    pipe = SDXLPipeline.from_pretrained("/path/to/checkpoint")
    images = pipe(["a photograph of an astronaut riding a horse"],
                  height=1024, width=1024, num_inference_steps=28,
                  guidance_scale=5.0, seed=0)
    images[0]  # HWC uint8 numpy array

Every draw comes from a generator on the model's device seeded with
``seed``, unless the caller passes it (``noise=``, and the VAE encode's
draws): the VAE encodes first, then the sampler draws its noise.  Mesh
serving is not ported (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.tokenizer import (
    TokenizerPair, load_tokenizers)
from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
from sdxl_training_improvements_tpu_torch.training.schedules import (
    NoiseSchedule)
from sdxl_training_improvements_tpu_torch.training.validation import (
    ValidationSampler)


def _read_ckpt_json(path: Path):
    """A checkpoint's declaration file: absent -> None (a plain diffusers
    export; defaults apply); present but unreadable or not a JSON object
    -> ValueError naming the file (defaults would sample the wrong
    topology or schedule)."""
    if not path.exists():
        return None
    try:
        raw = json.loads(path.read_text())
    except OSError as e:
        raise ValueError(f"unreadable checkpoint config {path}: {e}")
    except ValueError as e:
        raise ValueError(f"corrupt checkpoint config {path}: not valid "
                         f"JSON ({e})")
    if not isinstance(raw, dict):
        raise ValueError(f"corrupt checkpoint config {path}: top level "
                         f"must be a JSON object, got {type(raw).__name__}")
    return raw


class SDXLPipeline:
    def __init__(self, model: SDXLModel, tokenizers: TokenizerPair,
                 schedule: Optional[NoiseSchedule] = None,
                 method: str = "ddpm", sampler: str = "euler",
                 deep_cache: int = 1):
        self.model = model
        self.tokenizers = tokenizers
        self.schedule = schedule or NoiseSchedule.create()
        self.method = method  # ddpm | flow_matching
        self.sampler = sampler  # euler | dpmpp_2m (sigma space)
        self.deep_cache = deep_cache  # DeepCache interval, 1 = off

    # ------------------------------------------- checkpoint declarations
    @staticmethod
    def declared_method(model_dir) -> Optional[str]:
        """``training.method`` of the checkpoint's root ``config.json``
        (``export_diffusers`` writes it), or None."""
        raw = _read_ckpt_json(Path(model_dir) / "config.json")
        if raw is None:
            return None
        t = raw.get("training")
        if t is None:
            return None
        if not isinstance(t, dict):
            raise ValueError(
                f"corrupt checkpoint config {Path(model_dir)/'config.json'}:"
                f" key 'training' must be a mapping, got {type(t).__name__}")
        return t.get("method") or None

    @classmethod
    def detect_method(cls, model_dir) -> str:
        """``declared_method``, "ddpm" when the checkpoint declares none."""
        return cls.declared_method(model_dir) or "ddpm"

    @staticmethod
    def declared_schedule(model_dir) -> Optional[NoiseSchedule]:
        """The ``NoiseSchedule`` of the checkpoint's root ``config.json``
        (``model.*`` sigma range, ZTSNR, rho, MinSNR and
        ``training.prediction_type``, as ``NoiseSchedule.from_config``
        reads them), or None without one.  A corrupt value raises with its
        key named: the wrong sigma space samples garbage."""
        cfg_path = Path(model_dir) / "config.json"
        raw = _read_ckpt_json(cfg_path)
        if raw is None:
            return None
        m = raw.get("model") or {}
        t = raw.get("training") or {}
        if not isinstance(m, dict) or not isinstance(t, dict) or not m:
            return None
        kwargs = {}
        for field_name, cast in (("num_timesteps", int),
                                 ("sigma_min", float),
                                 ("sigma_max", float),
                                 ("rho", float),
                                 ("use_ztsnr", bool)):
            if m.get(field_name) is not None:
                try:
                    kwargs[field_name] = cast(m[field_name])
                except (TypeError, ValueError):
                    raise ValueError(
                        f"corrupt checkpoint config {cfg_path}: "
                        f"model.{field_name}={m[field_name]!r} is not a "
                        f"valid {cast.__name__}")
        if "min_snr_gamma" in m:  # None is a valid (off) setting
            g = m["min_snr_gamma"]
            try:
                kwargs["min_snr_gamma"] = (None if g in (None, "None")
                                           else float(g))
            except (TypeError, ValueError):
                raise ValueError(
                    f"corrupt checkpoint config {cfg_path}: "
                    f"model.min_snr_gamma={g!r} is not a valid float")
        if t.get("prediction_type"):
            kwargs["prediction_type"] = str(t["prediction_type"])
        try:
            return NoiseSchedule.create(**kwargs)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"checkpoint config {cfg_path} declares an invalid "
                f"schedule ({kwargs}): {e}")

    @staticmethod
    def declared_unet_config(model_dir) -> Optional[UNetConfig]:
        """``UNetConfig`` of the checkpoint's ``unet/config.json``, or
        None: what makes refiner and inpainting checkpoints load without
        flags."""
        raw = _read_ckpt_json(Path(model_dir) / "unet" / "config.json")
        if raw is None:
            return None
        return UNetConfig.from_diffusers_config(raw)

    # ------------------------------------------------------------ builders
    @classmethod
    def from_pretrained(cls, model_dir, tiny: bool = False,
                        schedule: Optional[NoiseSchedule] = None,
                        method: Optional[str] = None,
                        sampler: str = "euler", deep_cache: int = 1,
                        dtype=torch.bfloat16, device="cuda"
                        ) -> "SDXLPipeline":
        """Load a diffusers-layout checkpoint directory onto ``device``
        (the card unless the caller asks for the CPU), the UNet and CLIPs
        in ``dtype``, the VAE fp32.  ``method=None`` follows the
        checkpoint's ``config.json``; a different explicit method raises
        before any weight is read.  The UNet topology follows
        ``unet/config.json``; a 5-time-id UNet, or text_encoder_2/ without
        text_encoder/, is a single-encoder (refiner) checkpoint.
        ``tiny`` builds the miniature VAE and CLIPs."""
        from sdxl_training_improvements_tpu_torch.training.checkpoints import (
            import_diffusers)
        model_dir = Path(model_dir)
        declared = cls.declared_method(model_dir)
        if method and declared and method != declared:
            raise ValueError(
                f"checkpoint at {model_dir} was trained with method "
                f"{declared!r}; refusing to sample it as {method!r}. "
                "Use --method auto (or omit method) to follow the "
                "checkpoint.")
        method = method or declared or "ddpm"
        schedule = schedule or cls.declared_schedule(model_dir)
        ucfg = cls.declared_unet_config(model_dir)
        refiner = (ucfg is not None and ucfg.num_time_ids == 5) or (
            (model_dir / "text_encoder_2").exists()
            and not (model_dir / "text_encoder").exists())
        if ucfg is not None and tiny:
            # runtime knobs are not topology: the tiny test defaults
            ucfg = dataclasses.replace(ucfg, remat=False)
        model = SDXLModel.create(tiny=tiny, dtype=dtype, device=device,
                                 unet_config=ucfg, refiner=refiner,
                                 init_weights=False)
        loaded = import_diffusers(model, model_dir)
        required = {"unet", "vae", "clip_g"} | (
            set() if refiner else {"clip_l"})
        missing = required - loaded
        if missing:
            raise FileNotFoundError(
                f"checkpoint at {model_dir} missing components: "
                f"{sorted(missing)}")
        return cls(model,
                   load_tokenizers(
                       model_dir, single_encoder=refiner,
                       fallback_vocab_size=model.clip_g.cfg.vocab_size),
                   schedule, method=method, sampler=sampler,
                   deep_cache=deep_cache)

    @classmethod
    def from_model(cls, model: SDXLModel,
                   tokenizers: Optional[TokenizerPair] = None,
                   schedule: Optional[NoiseSchedule] = None,
                   method: str = "ddpm", sampler: str = "euler",
                   deep_cache: int = 1) -> "SDXLPipeline":
        if tokenizers is None:
            # the hash fallback must match this model's vocabulary
            tokenizers = TokenizerPair.fallback(
                vocab_size=model.clip_g.cfg.vocab_size)
        return cls(model, tokenizers, schedule, method=method,
                   sampler=sampler, deep_cache=deep_cache)

    # ----------------------------------------------------------- internals
    def _sampler(self, num_inference_steps: int,
                 guidance_scale: float) -> ValidationSampler:
        return ValidationSampler(self.model, self.tokenizers, self.schedule,
                                 num_inference_steps=num_inference_steps,
                                 guidance_scale=guidance_scale,
                                 method=self.method, sampler=self.sampler,
                                 deep_cache_interval=self.deep_cache)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.model.device).manual_seed(seed)

    @torch.inference_mode()
    def _encode_pixels(self, images: Sequence[np.ndarray], height: int,
                       width: int, generator=None,
                       noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """HWC images (uint8 [0, 255] or float [-1, 1]) -> sampled, scaled
        VAE latents [n, C, height/f, width/f]; ``noise`` or ``generator``
        for the sample's draw."""
        arrs = []
        for i, img in enumerate(images):
            a = np.asarray(img)
            if a.ndim != 3 or a.shape[2] != 3:
                raise ValueError(f"image {i}: expected HWC RGB, got shape "
                                 f"{a.shape}")
            if a.shape[0] != height or a.shape[1] != width:
                raise ValueError(
                    f"image {i}: {a.shape[:2]} != ({height}, {width}): "
                    "resize before calling")
            if np.issubdtype(a.dtype, np.integer):
                a = a.astype(np.float32) / 127.5 - 1.0
            else:
                a = a.astype(np.float32)  # already [-1, 1]
            arrs.append(a.transpose(2, 0, 1))
        pixels = torch.from_numpy(np.stack(arrs)).to(self.model.device)
        if noise is not None:
            noise = noise.to(self.model.device)
        return self.model.encode_images(pixels, noise=noise,
                                        generator=generator)

    # ------------------------------------------------------------ text2img
    def __call__(self, prompts: Sequence[str], height: int = 1024,
                 width: int = 1024, num_inference_steps: int = 28,
                 guidance_scale: float = 5.0, seed: int = 0,
                 negative_prompts: Optional[Sequence[str]] = None,
                 denoising_end: Optional[float] = None,
                 noise: Optional[torch.Tensor] = None,
                 return_latents: bool = False) -> List[np.ndarray]:
        """Text -> image.  ``denoising_end`` is the base stage of the
        base->refiner handoff: stop at that fraction of the sigma walk and
        return the still-noisy latents for ``refine``."""
        sampler = self._sampler(num_inference_steps, guidance_scale)
        return sampler.generate(list(prompts), self._generator(seed),
                                height=height, width=width,
                                negative_prompts=negative_prompts,
                                noise=noise, denoising_end=denoising_end,
                                return_latents=return_latents
                                or denoising_end is not None)

    # ------------------------------------------------------------- img2img
    def img2img(self, prompts: Sequence[str],
                images: Optional[Sequence[np.ndarray]] = None,
                latents: Optional[torch.Tensor] = None,
                strength: float = 0.3, num_inference_steps: int = 28,
                guidance_scale: float = 5.0, seed: int = 0,
                negative_prompts: Optional[Sequence[str]] = None,
                aesthetic_score: float = 6.0,
                negative_aesthetic_score: float = 2.5,
                noise: Optional[torch.Tensor] = None,
                encode_noise: Optional[torch.Tensor] = None,
                return_latents: bool = False) -> List[np.ndarray]:
        """Image -> image: noise the init to ``strength`` of the schedule
        and denoise back down.  HWC ``images`` (uint8 or [-1, 1] float,
        encoded here, drawing ``encode_noise``) or encoded ``latents``
        [n, C, h/f, w/f].  On a refiner this is the refinement pass, with
        its aesthetic-score rows."""
        if (images is None) == (latents is None):
            raise ValueError("img2img wants exactly one of images/latents")
        f = self.model.vae.config.downscale_factor
        generator = self._generator(seed)
        if latents is None:
            h, w = np.asarray(images[0]).shape[:2]
            latents = self._encode_pixels(images, h, w, generator,
                                          encode_noise)
        else:
            h, w = latents.shape[2] * f, latents.shape[3] * f
        if len(prompts) != latents.shape[0]:
            raise ValueError(f"{len(prompts)} prompts for "
                             f"{latents.shape[0]} images")
        sampler = self._sampler(num_inference_steps, guidance_scale)
        return sampler.generate(list(prompts), generator, height=h, width=w,
                                negative_prompts=negative_prompts,
                                noise=noise, init_latents=latents,
                                strength=strength,
                                aesthetic_score=aesthetic_score,
                                negative_aesthetic_score=(
                                    negative_aesthetic_score),
                                return_latents=return_latents)

    # ---------------------------------------------------------- refinement
    def refine(self, prompts: Sequence[str], noisy_latents: torch.Tensor,
               denoising_start: float = 0.8,
               num_inference_steps: int = 28, guidance_scale: float = 5.0,
               seed: int = 0,
               negative_prompts: Optional[Sequence[str]] = None,
               aesthetic_score: float = 6.0,
               negative_aesthetic_score: float = 2.5,
               noise: Optional[torch.Tensor] = None,
               return_latents: bool = False) -> List[np.ndarray]:
        """The second stage of the handoff: walk the rest of the sigma
        ramp from the noisy latents a base pipeline returned with
        ``denoising_end=denoising_start``.  Both stages must use the same
        ``num_inference_steps``."""
        f = self.model.vae.config.downscale_factor
        h, w = noisy_latents.shape[2] * f, noisy_latents.shape[3] * f
        sampler = self._sampler(num_inference_steps, guidance_scale)
        return sampler.generate(list(prompts), self._generator(seed),
                                height=h, width=w,
                                negative_prompts=negative_prompts,
                                noise=noise, init_latents=noisy_latents,
                                denoising_start=denoising_start,
                                aesthetic_score=aesthetic_score,
                                negative_aesthetic_score=(
                                    negative_aesthetic_score),
                                return_latents=return_latents)

    # ------------------------------------------------------------- inpaint
    def inpaint(self, prompts: Sequence[str],
                images: Sequence[np.ndarray],
                masks: Sequence[np.ndarray], strength: float = 1.0,
                num_inference_steps: int = 28, guidance_scale: float = 5.0,
                seed: int = 0,
                negative_prompts: Optional[Sequence[str]] = None,
                noise: Optional[torch.Tensor] = None,
                masked_noise: Optional[torch.Tensor] = None,
                image_noise: Optional[torch.Tensor] = None,
                return_latents: bool = False) -> List[np.ndarray]:
        """Masked editing through a 9-channel inpainting UNet: each step's
        input is [noisy latents (4) | mask (1) | masked-image latents
        (4)].  ``masks`` are HxW arrays, nonzero = repaint.  ``strength``
        < 1 also starts the walk from the noised original's latents.  The
        masked image is encoded first (``masked_noise``), then the
        original (``image_noise``), then the sampler draws (``noise``)."""
        lat_c = self.model.vae.config.latent_channels
        if self.model.unet_config.in_channels != 2 * lat_c + 1:
            raise ValueError(
                f"inpaint needs an inpainting UNet (in_channels="
                f"{2 * lat_c + 1}); this checkpoint has "
                f"{self.model.unet_config.in_channels}")
        if not (len(prompts) == len(images) == len(masks)):
            raise ValueError("prompts/images/masks length mismatch")
        f = self.model.vae.config.downscale_factor
        h, w = np.asarray(images[0]).shape[:2]
        generator = self._generator(seed)
        bin_masks, masked_imgs = [], []
        for img, mask in zip(images, masks):
            a = np.asarray(img)
            m = (np.asarray(mask) != 0).astype(np.float32)
            if m.shape != (h, w):
                raise ValueError(f"mask shape {m.shape} != image ({h}, {w})")
            if np.issubdtype(a.dtype, np.integer):
                a = a.astype(np.float32) / 127.5 - 1.0
            masked_imgs.append(a * (1.0 - m)[..., None])
            bin_masks.append(m)
        masked_latents = self._encode_pixels(masked_imgs, h, w, generator,
                                             masked_noise)
        # nearest downsample to the latent grid (diffusers'
        # interpolate(mode="nearest"))
        m = np.stack(bin_masks)[:, f // 2::f, f // 2::f]
        mask_lat = torch.from_numpy(np.ascontiguousarray(m[:, None])).to(
            masked_latents.device)
        extra = torch.cat([mask_lat, masked_latents.float()], dim=1)
        init_latents = None
        if strength < 1.0:
            init_latents = self._encode_pixels(list(images), h, w, generator,
                                               image_noise)
        sampler = self._sampler(num_inference_steps, guidance_scale)
        return sampler.generate(list(prompts), generator, height=h, width=w,
                                negative_prompts=negative_prompts,
                                noise=noise, init_latents=init_latents,
                                strength=strength, extra_channels=extra,
                                return_latents=return_latents)
