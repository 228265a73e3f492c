"""Image sampling with classifier-free guidance, in PyTorch.

Port of ``ValidationSampler`` from ``sdxl_training_improvements_tpu/
training/validation.py``: ``method`` "ddpm" (v-prediction or epsilon)
walks the sigma-space samplers (the ZTSNR Karras-Euler or DPM++(2M)),
"flow_matching" the OT Euler ODE; DeepCache on the sigma-space samplers;
the img2img entry, the inpainting channels and the base->refiner handoff;
aesthetic-score rows for 5-time-id (refiner) UNets; and
``latents_to_images``.  Mesh serving (``mesh=``, JAX ``:84-115``,
``:293-300``): every rank of the mesh runs the sampler; the UNet is put
on the mesh's tensor axis once per parameter tree (a megatron-split
copy, ``models/unet.py`` ``place_on_mesh``; JAX's ``_place_params``
cache), and each UNet call runs this rank's block of the CFG-stacked
[2n] rows when they divide by data x fsdp (JAX's ``_bshard``), the
blocks gathered before the guidance combine.  The training loop's
pieces: ``ValidationLogger``
(sample the validation prompts, write PNGs with ``png.write_png``, log
them) and ``validation_loss`` (the training method's loss over held-out
batches, deterministic across calls).
"""
from __future__ import annotations

import math
import weakref
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.png import write_png
from sdxl_training_improvements_tpu_torch.training import schedules as S
from sdxl_training_improvements_tpu_torch.training.methods import get_method


# a UNet -> (the key of its parameter tree and mesh, its megatron-split
# copy): the samplers of one pipeline place it once
_PLACED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def latents_to_images(decoded: torch.Tensor) -> List[np.ndarray]:
    """[-1, 1] NCHW float -> list of HWC uint8 arrays."""
    arr = decoded.float().clamp(-1, 1).cpu().numpy()
    arr = np.nan_to_num(arr, nan=0.0, posinf=1.0, neginf=-1.0)
    arr = ((arr + 1.0) * 127.5).astype(np.uint8)
    return [a.transpose(1, 2, 0) for a in arr]


class ValidationSampler:
    """``method`` picks the sampler family the UNet was trained for:
    "ddpm" -> the sigma-space ``sampler`` ("euler" or "dpmpp_2m");
    "flow_matching" -> ``schedules.sample_flow``.  ``deep_cache_interval``
    k > 1 runs the full UNet every k-th step and only its shallow stages
    around the cached deep feature in between (sigma-space samplers
    only)."""

    def __init__(self, model, tokenizers, schedule: S.NoiseSchedule,
                 num_inference_steps: int = 28, guidance_scale: float = 5.0,
                 method: str = "ddpm", mesh=None, sampler: str = "euler",
                 deep_cache_interval: int = 1):
        if method not in ("ddpm", "flow_matching"):
            raise ValueError(
                f"ValidationSampler supports methods 'ddpm' and "
                f"'flow_matching', got {method!r}")
        if sampler not in ("euler", "dpmpp_2m"):
            raise ValueError(
                f"sampler must be 'euler' or 'dpmpp_2m', got {sampler!r}")
        if sampler != "euler" and method == "flow_matching":
            raise ValueError(
                "dpmpp_2m is a sigma-space sampler; flow_matching models "
                "integrate the OT ODE (sampler='euler' only)")
        if deep_cache_interval < 1:
            raise ValueError(
                f"deep_cache_interval must be >= 1, got {deep_cache_interval}")
        if deep_cache_interval > 1 and method == "flow_matching":
            raise ValueError(
                "deep_cache is wired for the sigma-space samplers only")
        self.mesh = mesh
        self._dp_group = None
        if mesh is not None:
            from sdxl_training_improvements_tpu_torch.parallel import (
                mesh as M)
            self._dp_group = M.dp_group(mesh)  # every rank: a collective
        self.model = model
        self.tokenizers = tokenizers
        self.schedule = schedule
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        self.method = method
        self.sampler = sampler
        self.deep_cache_interval = deep_cache_interval
        # log of the trained sigma table, fp32 as the JAX sampler forms it
        self._log_sigmas = np.log(np.maximum(
            schedule.sigmas.numpy().astype(np.float32), np.float32(1e-8)))

    def _conditioning(self, enc, n: int, height: int, width: int,
                      aesthetic_score: float = 6.0,
                      negative_aesthetic_score: float = 2.5):
        """[cond; neg]-ordered encoder output -> CFG-stacked [uncond; cond]
        prompt embeds, pooled embeds and time ids (``_time_ids``)."""
        pe, pooled = self._cfg_rows(enc, n)
        return pe, pooled, self._time_ids(n, height, width, aesthetic_score,
                                          negative_aesthetic_score, pe.device)

    @staticmethod
    def _cfg_rows(enc, n: int):
        """The encoder's [cond; neg] rows as [uncond; cond]: (prompt
        embeds, pooled embeds)."""
        pe = torch.cat([enc["prompt_embeds"][n:], enc["prompt_embeds"][:n]])
        pooled = torch.cat([enc["pooled_prompt_embeds"][n:],
                            enc["pooled_prompt_embeds"][:n]])
        return pe, pooled

    def _time_ids(self, n: int, height: int, width: int,
                  aesthetic_score: float, negative_aesthetic_score: float,
                  device) -> torch.Tensor:
        """[2n, ids] fp32: [h, w, 0, 0, h, w] for 6-id UNets, [h, w, 0, 0,
        score] for 5-id ones (the refiner; the negative score on the
        uncond rows)."""
        if self.model.unet_config.num_time_ids == 5:
            rows = ([[height, width, 0, 0, negative_aesthetic_score]] * n
                    + [[height, width, 0, 0, aesthetic_score]] * n)
        else:
            rows = [[height, width, 0, 0, height, width]] * (2 * n)
        return torch.tensor(rows, dtype=torch.float32, device=device)

    def timestep_index(self, sigma: float) -> int:
        """Nearest trained timestep to ``sigma`` in log space.  sigma = inf
        (the ZTSNR first step) maps to index 0, the index JAX's argmin
        returns over that all-inf distance vector."""
        if math.isinf(sigma):
            return 0
        target = np.log(np.maximum(np.float32(sigma), np.float32(1e-8)))
        return int(np.argmin(np.abs(self._log_sigmas - target)))

    def _unet_batch(self, x, extra):
        """[x; x] for the CFG rows, with the conditioning channels."""
        x2 = torch.cat([x, x])
        if extra is not None:
            x2 = torch.cat([x2, extra.to(x2.dtype)], dim=1)
        return x2

    def _cfg(self, pred, guidance_scale: Optional[float] = None):
        """The fp32 CFG combine of [uncond; cond] rows, at this sampler's
        guidance scale unless another is given."""
        g = self.guidance_scale if guidance_scale is None else guidance_scale
        uncond, cond = pred.float().chunk(2)
        return uncond + g * (cond - uncond)

    def _unet(self):
        """The UNet to call on the mesh: the model's, or with a tensor
        axis above 1 its megatron-split copy, placed once per parameter
        tree (the model's UNet when it is placed already, as in
        training)."""
        from sdxl_training_improvements_tpu_torch.parallel import mesh as M
        unet = self.model.unet
        if M.axis_sizes(self.mesh)[M.TENSOR_AXIS] == 1 \
                or any(getattr(m, "tp_group", None) is not None
                       for m in unet.modules()):
            return unet
        key = (id(self.mesh),) + tuple((id(p), p.data_ptr(), p._version)
                                       for p in unet.parameters())
        placed = _PLACED.get(unet)
        if placed is None or placed[0] != key:
            from sdxl_training_improvements_tpu_torch.models.unet import (
                place_on_mesh)
            _PLACED.pop(unet, None)  # the old copy goes before the new one
            placed = _PLACED[unet] = (key, place_on_mesh(
                unet, self.mesh, copy_module=True)[0])
        return placed[1]

    def _rows(self):
        """(this rank's block of the CFG rows, the blocks) on a mesh, or
        None without one."""
        if self.mesh is None:
            return None
        from sdxl_training_improvements_tpu_torch.parallel import mesh as M
        return M.batch_index(self.mesh)

    def _gather_rows(self, local: torch.Tensor, blocks: int) -> torch.Tensor:
        """Every rank's block of rows, joined in block order."""
        import torch.distributed as dist
        out = torch.empty((blocks * local.shape[0],) + local.shape[1:],
                          dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(out, local.contiguous(),
                                    group=self._dp_group)
        return out.contiguous(memory_format=torch.channels_last) \
            if local.dim() == 4 else out

    def _apply(self, kind: str, x, t, prompt_embeds, pooled, time_ids,
               extra=None, deep=None):
        """One CFG UNet call on [x; x] at the timestep vector ``t``:
        "full", "deep" (the full call and its deep feature, DeepCache) or
        "shallow" (the shallow stages around ``deep``).  ``extra`` ([2B, K,
        h, w], CFG-stacked already) joins the input's channels: the
        inpainting mask and masked latents.  On a mesh the rank runs its
        block of the rows (when they divide) and the prediction is
        gathered whole; a deep feature stays the rank's block."""
        args = [self._unet_batch(x, extra), t, prompt_embeds, pooled,
                time_ids]
        unet = self.model.unet_apply if self.mesh is None else self._unet()
        rows = self._rows()
        blocks = 1
        if rows is not None and args[0].shape[0] % rows[1] == 0:
            index, blocks = rows
            k = args[0].shape[0] // blocks
            args = [a[index * k:(index + 1) * k] for a in args]
        if kind == "deep":
            pred, feat = unet(*args, return_deep=True)
            return (pred if blocks == 1
                    else self._gather_rows(pred, blocks)), feat
        out = (unet(*args, deep_cache=deep) if kind == "shallow"
               else unet(*args))
        return out if blocks == 1 else self._gather_rows(out, blocks)

    def _unet_call(self, prompt_embeds, pooled, time_ids, extra=None):
        """The eager ``unet(kind, x, t, deep=None)`` that ``sample_latents``
        drives: ``t`` is the timestep index, or the float time t in [0, 1]
        that a flow-matching UNet takes itself."""
        dtype = (torch.float32 if self.method == "flow_matching"
                 else torch.int64)

        def unet(kind, x, t, deep=None):
            tvec = torch.full((2 * x.shape[0],), t, dtype=dtype,
                              device=x.device)
            return self._apply(kind, x, tvec, prompt_embeds, pooled,
                               time_ids, extra, deep)

        return unet

    def _denoiser(self, prompt_embeds, pooled, time_ids, extra=None):
        """model_fn(x, sigma): the raw network at t(sigma) on the doubled
        batch [uncond; cond], combined in fp32 with the guidance scale."""
        unet = self._unet_call(prompt_embeds, pooled, time_ids, extra)
        return lambda x, sigma: self._cfg(
            unet("full", x, self.timestep_index(sigma)))

    def sample_latents(self, unet, lat_shape, guidance_scale=None, **kw):
        """This sampler's family run around ``unet(kind, x, t, deep=None)``
        (``_unet_call``'s, or the replay of a captured graph), combined in
        fp32 at ``guidance_scale`` (this sampler's unless given); ``kw``
        goes to the ``schedules`` sampler.  With DeepCache a step with
        step % k == 0 runs the full UNet and refreshes the deep feature;
        the others run the shallow stages around the cached one."""
        g = guidance_scale
        if self.method == "flow_matching":
            return S.sample_flow(
                lambda x, t: self._cfg(unet("full", x, float(t)), g),
                lat_shape, **kw)
        k = self.deep_cache_interval
        if k > 1:
            def model_fn(x, sigma, aux):
                step, deep = aux
                t = self.timestep_index(sigma)
                if step % k == 0:
                    pred, deep = unet("deep", x, t)
                else:
                    pred = unet("shallow", x, t, deep)
                return self._cfg(pred, g), (step + 1, deep)
            # (step, deep): step 0 always refreshes, so no placeholder
            aux0 = (0, None)
        else:
            def model_fn(x, sigma):
                return self._cfg(unet("full", x, self.timestep_index(sigma)),
                                 g)
            aux0 = None
        sample = (S.sample_dpmpp_2m if self.sampler == "dpmpp_2m"
                  else S.sample_ztsnr)
        return sample(model_fn, lat_shape, self.schedule, aux0=aux0, **kw)

    @torch.inference_mode()
    def generate(self, prompts: Sequence[str],
                 generator: Optional[torch.Generator] = None,
                 height: int = 1024, width: int = 1024,
                 negative_prompts: Optional[Sequence[str]] = None,
                 noise: Optional[torch.Tensor] = None,
                 init_latents: Optional[torch.Tensor] = None,
                 strength: float = 1.0,
                 extra_channels: Optional[torch.Tensor] = None,
                 aesthetic_score: float = 6.0,
                 negative_aesthetic_score: float = 2.5,
                 denoising_start: Optional[float] = None,
                 denoising_end: Optional[float] = None,
                 return_latents: bool = False):
        """One image per prompt as HWC uint8 arrays (or the latents).

        ``noise`` [n, C_lat, h/f, w/f] replaces the sampler's draw from
        ``generator``.  ``init_latents`` + ``strength`` run img2img;
        ``extra_channels`` [n, K, h/f, w/f] join the UNet input every step
        (inpainting); ``denoising_start``/``denoising_end`` are the
        base->refiner handoff; ``return_latents`` skips the VAE decode."""
        negs = (list(negative_prompts) if negative_prompts
                else [""] * len(prompts))
        if len(negs) != len(prompts):
            raise ValueError(f"negative_prompts ({len(negs)}) must match "
                             f"prompts ({len(prompts)})")
        device = self.model.device
        ids_l, ids_g = self.tokenizers(list(prompts) + negs)
        enc = self.model.encode_prompt(
            torch.as_tensor(ids_l, dtype=torch.int64, device=device),
            torch.as_tensor(ids_g, dtype=torch.int64, device=device))
        n = len(prompts)
        pe, pooled, time_ids = self._conditioning(
            enc, n, height, width, aesthetic_score, negative_aesthetic_score)
        extra = None
        if extra_channels is not None:
            extra_channels = extra_channels.to(device)
            extra = torch.cat([extra_channels, extra_channels])
        f = self.model.vae.config.downscale_factor
        lat_ch = self.model.unet_config.in_channels - (
            0 if extra_channels is None else extra_channels.shape[1])
        lat_shape = (n, lat_ch, height // f, width // f)
        if init_latents is not None:
            if tuple(init_latents.shape) != lat_shape:
                raise ValueError(
                    f"init_latents shape {tuple(init_latents.shape)} != "
                    f"expected {lat_shape}")
            init_latents = init_latents.to(device)
        if noise is not None:
            noise = noise.to(device)
        kw = dict(num_steps=self.num_inference_steps, noise=noise,
                  generator=generator, device=device, init=init_latents,
                  strength=strength)
        if denoising_start is not None or denoising_end is not None:
            if self.method == "flow_matching":
                raise ValueError("denoising_start/denoising_end (the "
                                 "base->refiner sigma handoff) apply to the "
                                 "sigma-space sampler only, not "
                                 "flow_matching")
            kw.update(denoising_start=denoising_start,
                      denoising_end=denoising_end)
        latents = self.sample_latents(
            self._unet_call(pe, pooled, time_ids, extra), lat_shape, **kw)
        if return_latents:
            return latents
        return latents_to_images(self.model.decode_latents(latents))


class ValidationLogger:
    """Periodic sampling + PNG save + image-sink logging (the reference
    ``ValidationLogger.run_validation`` intent, ``validation.py:33-92``)."""

    def __init__(self, sampler: ValidationSampler, prompts: Sequence[str],
                 output_dir, logger=None, height: int = 1024,
                 width: int = 1024):
        self.sampler = sampler
        self.prompts = list(prompts)
        self.output_dir = Path(output_dir)
        self.logger = logger
        self.height, self.width = height, width

    def run_validation(self, step: int,
                       generator: Optional[torch.Generator] = None
                       ) -> List[Path]:
        """One image per prompt from the sampler's model as it stands,
        written to ``validation-<step>/NN.png``; the draws come from a
        generator seeded with ``step`` unless one is given."""
        if generator is None:
            generator = torch.Generator(
                device=self.sampler.model.device).manual_seed(step)
        images = self.sampler.generate(self.prompts, generator,
                                       self.height, self.width)
        out_dir = self.output_dir / f"validation-{step:06d}"
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for i, img in enumerate(images):
            p = out_dir / f"{i:02d}.png"
            try:
                write_png(p, img)
                paths.append(p)
            except OSError as e:  # disk full / unwritable dir: say so
                if self.logger is not None:
                    self.logger.warning(
                        f"validation image save failed for {p}: {e}")
        if self.logger is not None:
            self.logger.log_images(
                {f"validation/{i:02d}": img for i, img in enumerate(images)},
                step=step)
            self.logger.info(f"Validation images at step {step} -> {out_dir}")
        return paths


def validation_loss(unet_apply, dataset, schedule, config, seed: int,
                    max_batches: int = 8, num_time_ids: int = 6,
                    device="cuda") -> Optional[float]:
    """Mean training-method loss over the validation set, under
    ``torch.no_grad``.

    Deterministic across calls: the epoch-0 batch order, and batch ``i``'s
    draws from its own generator seeded by ``(seed, i)`` (JAX's
    ``fold_in(key, i)``), so epoch-over-epoch values are comparable; this
    is what drives best-checkpoint selection when
    ``data.validation_data_dir`` is set."""
    from sdxl_training_improvements_tpu_torch.data.pipeline import (
        adapt_batch_time_ids, batches_for_epoch)

    loss_fn = get_method(config.training.method)
    mcfg = config.model
    losses = []
    with torch.no_grad():
        for i, batch in enumerate(batches_for_epoch(
                dataset, config.training.batch_size, epoch=0,
                seed=config.training.seed)):
            if i >= max_batches:
                break
            if num_time_ids != 6:  # refiner fine-tune: 5-id conditioning
                batch = adapt_batch_time_ids(
                    batch, num_time_ids,
                    getattr(mcfg, "aesthetic_score", 6.0))
            gen = torch.Generator(device=device).manual_seed(
                seed * 100003 + i)
            tbatch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                      for k, v in batch.items()}
            loss, _ = loss_fn(unet_apply, tbatch, gen, schedule, mcfg)
            losses.append(loss.detach())
    if not losses:
        return None
    return float(np.mean(torch.stack(losses).double().cpu().numpy()))
