"""Serving artifacts: the text-to-image program captured as CUDA graphs.

Port of ``sdxl_training_improvements_tpu/aot.py``.  JAX serializes the
whole program with ``jax.export`` and replays it; a CUDA graph cannot be
serialized, so here the artifact is ``meta.json`` alone, and the program is
captured when the artifact is loaded:

    artifact/
      meta.json       # JAX's keys: shapes, sampler family, schedule
                      # summary, the topology digest, torch_version

``export_text2img(pipeline, dir, ...)`` writes it; ``AOTPipeline.load(dir,
model, tokenizers)`` keeps JAX's checks (format version, refiner against
base topology, the parameter shape digest, the static batch and the
negative-prompt count) and, on a CUDA device, captures into one graph
memory pool, for the artifact's static batch, size, sampler, DeepCache
interval and method:

* ``encode``: the dual-CLIP (or CLIP-G) encode of the [cond; neg] token
  ids into the CFG rows;
* ``unet``: the CFG UNet call (x and the timestep in static buffers; the
  int64 timestep index, or the fp32 t for flow matching); with DeepCache
  ``unet_deep`` (the full call, ``return_deep``) and ``unet_shallow``
  (around the deep feature ``unet_deep`` wrote);
* ``decode``: the fp32 VAE decode to uint8 NHWC.

Each is run once eagerly on the capture's stream first (the kernels'
builds, their shared-memory attributes and tensor-map entry point, cuDNN's
plans), then captured; a failed capture raises.  What JAX takes as runtime
inputs stays outside the graphs: the sampler's Euler / DPM++ 2M / flow
arithmetic and the CFG combine run eagerly between replays, so
``guidance_scale`` is a runtime input, and the initial noise is drawn from
``torch.Generator(device).manual_seed(seed)`` as ``SDXLPipeline`` draws it
(or injected: ``noise=``), then copied into the static buffer.  Static
buffers are filled with ``copy_``/``fill_``, never rebound: the flash
kernels' tensor maps hold their addresses.  Replays run on the current
stream in the order the sampler calls them.  On a CPU device, passed
explicitly, the same code runs eagerly with no capture.

A kernel wrapper's launch counter counts a capture once; the runner counts
its replays (``replays``) and each graph's launches per capture
(``captured_launches``), and ``kernel_launches()`` is their product.
"""
from __future__ import annotations

import collections
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.training import schedules as S
from sdxl_training_improvements_tpu_torch.training.validation import (
    ValidationSampler)

_META = "meta.json"
_FORMAT_VERSION = 1
_COMPONENTS = ("unet", "vae", "clip_l", "clip_g")
_SEQ_LEN = 77
# the graph of each kind of UNet call
_UNET_GRAPH = {"full": "unet", "deep": "unet_deep", "shallow": "unet_shallow"}


def param_shape_digest(model) -> str:
    """sha256 over the sorted (flax path, flax shape, dtype) lines of the
    bundle's components, as JAX's ``_shape_digest`` (``aot.py:70-82``)
    forms them over the flax tree: dense kernels [in, out], convolution
    kernels HWIO.  A topology fingerprint: the digest of weights carried
    from JAX equals JAX's of the originals."""
    from sdxl_training_improvements_tpu_torch.models.lora import jax_path
    lines = []
    for comp in _COMPONENTS:
        module = getattr(model, comp)
        if module is None:
            continue
        for mod_name, mod in module.named_modules():
            for p_name, p in mod.named_parameters(recurse=False):
                path = jax_path(f"{mod_name}.{p_name}" if mod_name else p_name,
                                comp, mod).split("/")
                shape = tuple(p.shape)
                if path[-1] == "kernel":  # [out, in] / OIHW -> flax's
                    shape = (shape[::-1] if len(shape) == 2
                             else shape[2:] + (shape[1], shape[0]))
                lines.append(comp + "".join(f"[{s!r}]" for s in path)
                             + f":{shape}:{str(p.dtype)[len('torch.'):]}")
    return hashlib.sha256("\n".join(sorted(lines)).encode()).hexdigest()


def export_text2img(pipeline, out_dir, *, batch: int = 1,
                    height: int = 1024, width: int = 1024,
                    num_inference_steps: int = 28,
                    guidance_scale: float = 5.0,
                    aesthetic_score: float = 6.0,
                    negative_aesthetic_score: float = 2.5,
                    platforms: Sequence[str] = ("cuda", "cpu")) -> Path:
    """Write the artifact of ``pipeline``'s text-to-image path to
    ``out_dir``: ``meta.json`` with JAX's keys (``jax_version`` is
    ``torch_version``; ``platforms`` records the device types the caller
    allows).  ``guidance_scale`` is only the recorded default.  The
    graphs are captured by ``AOTPipeline.load``."""
    model = pipeline.model
    required = {"unet", "vae", "clip_g"}
    if model.clip_l is not None:
        required.add("clip_l")  # the base topology encodes with both
    missing = {c for c in required if getattr(model, c) is None}
    if missing:
        raise ValueError(f"pipeline model missing components: {missing} - "
                         "load or init the model before exporting")
    # the sampler's own refusals (flow with dpmpp_2m or DeepCache, ...)
    ValidationSampler(model, None, pipeline.schedule,
                      num_inference_steps=num_inference_steps,
                      method=pipeline.method, sampler=pipeline.sampler,
                      deep_cache_interval=pipeline.deep_cache)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    sched = pipeline.schedule
    meta = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "batch": batch, "height": height, "width": width,
        "seq_len": _SEQ_LEN,
        "num_inference_steps": num_inference_steps,
        "method": pipeline.method,
        "sampler": pipeline.sampler,
        "deep_cache": pipeline.deep_cache,
        "default_guidance_scale": guidance_scale,
        "aesthetic_score": aesthetic_score,
        "negative_aesthetic_score": negative_aesthetic_score,
        "refiner": model.clip_l is None,
        "param_shape_digest": param_shape_digest(model),
        "schedule": {
            "prediction_type": sched.prediction_type,
            "num_timesteps": int(sched.num_timesteps),
            "use_ztsnr": bool(sched.use_ztsnr),
            "rho": float(sched.rho),
            # sigmas is the descending Karras ramp
            "sigma_min": float(sched.sigmas[-1]),
            "sigma_max": float(sched.sigmas[0]),
        },
    }
    (out / _META).write_text(json.dumps(meta, indent=1))
    return out


def read_meta(artifact_dir) -> Dict[str, Any]:
    """An artifact's ``meta.json``; a format version this runtime does not
    read raises."""
    d = Path(artifact_dir)
    meta = json.loads((d / _META).read_text())
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"artifact {d} has format_version {meta.get('format_version')};"
            f" this runtime reads {_FORMAT_VERSION}")
    return meta


def _schedule(meta) -> S.NoiseSchedule:
    """The artifact's schedule, rebuilt from its summary (the ramp's ends
    are the fp32 table's, which ``karras_sigmas`` reproduces)."""
    s = meta["schedule"]
    return S.NoiseSchedule.create(
        num_timesteps=s["num_timesteps"], sigma_min=s["sigma_min"],
        sigma_max=s["sigma_max"], rho=s["rho"], use_ztsnr=s["use_ztsnr"],
        prediction_type=s["prediction_type"])


def _kernel_counts() -> Dict[str, int]:
    """Launches so far of the kernels the program runs, by instantiation
    (bf16 unsuffixed, ``_f16``, ``_f32``): GN+SiLU forward, flash
    forward."""
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    out = {}
    for dt, sfx in ((torch.bfloat16, ""), (torch.float16, "_f16"),
                    (torch.float32, "_f32")):
        out["gn_silu_fwd" + sfx] = G.gn_silu_fwd_cuda.launches_by_dtype[dt]
        out["flash_fwd" + sfx] = F.LAUNCHERS["fwd"][dt].launches
    return out


class AOTPipeline:
    """Text-to-image over an artifact and a model of its topology
    (module docstring).  Build it with ``load`` or ``from_pretrained``."""

    def __init__(self, meta: Dict[str, Any], model, tokenizers,
                 device="cuda"):
        self.meta = meta
        self.model = model
        self.tokenizers = tokenizers
        self.device = torch.device(device)
        self.sampler = ValidationSampler(
            model, tokenizers, _schedule(meta),
            num_inference_steps=meta["num_inference_steps"],
            guidance_scale=meta["default_guidance_scale"],
            method=meta["method"], sampler=meta["sampler"],
            deep_cache_interval=meta["deep_cache"])
        n = meta["batch"]
        f = model.vae.config.downscale_factor
        self.lat_shape = (n, model.unet_config.in_channels,
                          meta["height"] // f, meta["width"] // f)
        self._t_dtype = (torch.float32 if meta["method"] == "flow_matching"
                         else torch.int64)
        self.graphs: Dict[str, Any] = {}
        self.replays: collections.Counter = collections.Counter()
        self.captured_launches: Dict[str, Dict[str, int]] = {}
        with torch.inference_mode():
            self._time_ids = self.sampler._time_ids(
                n, meta["height"], meta["width"], meta["aesthetic_score"],
                meta["negative_aesthetic_score"], self.device)
        if self.device.type == "cuda":
            self._capture()

    # ----------------------------------------------------------- loading
    @classmethod
    def load(cls, artifact_dir, model, tokenizers,
             device="cuda") -> "AOTPipeline":
        """The artifact in ``artifact_dir`` over ``model`` (an
        ``SDXLModel`` on ``device``) and ``tokenizers`` (a
        ``TokenizerPair``); on a CUDA device the graphs are captured
        here."""
        d = Path(artifact_dir)
        meta = read_meta(d)
        refiner = model.clip_l is None
        if meta.get("refiner") != refiner:
            kind = "refiner" if meta.get("refiner") else "base (dual-CLIP)"
            have = ("refiner (no clip_l)" if refiner
                    else "base (has clip_l)")
            raise ValueError(
                f"artifact {d} was exported for a {kind} topology but the "
                f"supplied checkpoint is {have}")
        want = meta.get("param_shape_digest")
        if want is not None:
            got = param_shape_digest(model)
            if got != want:
                raise ValueError(
                    f"artifact {d} was exported for a different param "
                    f"topology: artifact shape digest {want[:12]}…, "
                    f"checkpoint {got[:12]}… - use a checkpoint of the "
                    "exported topology or re-export the artifact")
        device = torch.device(device)
        platforms = meta.get("platforms") or []
        if device.type not in platforms:
            raise ValueError(f"artifact {d} was exported for platforms "
                             f"{platforms}, not {device.type}")
        if model.device.type != device.type:
            raise ValueError(f"the model is on {model.device}; load it on "
                             f"{device} to run the artifact there")
        return cls(meta, model, tokenizers, device)

    @classmethod
    def from_pretrained(cls, artifact_dir, model_dir, tiny: bool = False,
                        device="cuda") -> "AOTPipeline":
        """The artifact over a diffusers-layout checkpoint directory: the
        port's loader supplies the weights (bf16 UNet and CLIPs) and the
        tokenizers."""
        from sdxl_training_improvements_tpu_torch.pipelines import (
            SDXLPipeline)
        pipe = SDXLPipeline.from_pretrained(model_dir, tiny=tiny,
                                            device=device)
        return cls.load(artifact_dir, pipe.model, pipe.tokenizers,
                        device=device)

    # --------------------------------------------- the program's pieces
    def _encode_fn(self, ids_l, ids_g):
        """Token ids -> the CFG rows (prompt embeds, pooled)."""
        from sdxl_training_improvements_tpu_torch.models.clip import (
            encode_dual, encode_g)
        m = self.model
        enc = (encode_g(m.clip_g, ids_g) if m.clip_l is None
               else encode_dual(m.clip_l, m.clip_g, ids_l, ids_g))
        return self.sampler._cfg_rows(enc, self.meta["batch"])

    def _decode_fn(self, latents):
        """Latents -> uint8 NHWC images (JAX ``aot.py:142-156``)."""
        img = self.model.decode_latents(latents.float()).float()
        img = torch.nan_to_num(img.clamp(-1.0, 1.0), nan=0.0, posinf=1.0,
                               neginf=-1.0)
        return ((img + 1.0) * 127.5).to(torch.uint8).permute(0, 2, 3, 1)

    # ----------------------------------------------------------- capture
    def _capture(self) -> None:
        n, dev = self.meta["batch"], self.device
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(dev)

        def capture(name, fn):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                fn()  # warm-up: builds, attributes, cuDNN plans
            torch.cuda.current_stream(dev).wait_stream(stream)
            torch.cuda.synchronize(dev)
            before = _kernel_counts()
            # the cudaGraph_t is kept (raw_cuda_graph) so that its nodes
            # can be counted; instantiated here, not at the first replay
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                out = fn()
            graph.instantiate()
            after = _kernel_counts()
            self.captured_launches[name] = {
                k: after[k] - before[k] for k in after if after[k] > before[k]}
            self.graphs[name] = graph
            return out

        with torch.inference_mode(), torch.cuda.device(dev):
            # static inputs: valid token ids and a zero latent for the
            # warm-up runs
            self._ids_l = torch.zeros((2 * n, _SEQ_LEN), dtype=torch.int64,
                                      device=dev)
            self._ids_g = torch.zeros_like(self._ids_l)
            self._x = torch.zeros(self.lat_shape, dtype=torch.float32,
                                  device=dev)
            self._t = torch.zeros((2 * n,), dtype=self._t_dtype, device=dev)
            self._pe, self._pooled = capture(
                "encode", lambda: self._encode_fn(self._ids_l, self._ids_g))
            self._out = {}
            kinds = (("deep", "shallow") if self.sampler.deep_cache_interval
                     > 1 else ("full",))
            for kind in kinds:
                deep = self._out["deep"][1] if kind == "shallow" else None
                self._out[kind] = capture(
                    _UNET_GRAPH[kind],
                    lambda kind=kind, deep=deep: self.sampler._apply(
                        kind, self._x, self._t, self._pe, self._pooled,
                        self._time_ids, deep=deep))
            self._latents = torch.zeros(self.lat_shape, dtype=torch.float32,
                                        device=dev)
            self._images = capture("decode",
                                   lambda: self._decode_fn(self._latents))
        torch.cuda.synchronize(dev)

    def _replay(self, name: str) -> None:
        self.graphs[name].replay()
        self.replays[name] += 1

    def kernel_launches(self) -> Dict[str, int]:
        """Kernel launches the replays so far made: each graph's launches
        per capture times its replays."""
        out: collections.Counter = collections.Counter()
        for name, counts in self.captured_launches.items():
            for k, c in counts.items():
                out[k] += c * self.replays[name]
        return dict(out)

    # ----------------------------------------------------------- running
    def _encode(self, ids_l, ids_g):
        if not self.graphs:
            return self._encode_fn(
                torch.as_tensor(ids_l, dtype=torch.int64, device=self.device),
                torch.as_tensor(ids_g, dtype=torch.int64, device=self.device))
        self._ids_l.copy_(torch.from_numpy(np.asarray(ids_l)))
        self._ids_g.copy_(torch.from_numpy(np.asarray(ids_g)))
        self._replay("encode")
        return self._pe, self._pooled

    def _unet(self, kind: str, x, t, deep=None):
        """The sampler's UNet call at timestep ``t`` (an index, or flow's
        t): a replay reading ``x`` and ``t`` copied into the static
        buffers; the shallow graph reads the deep feature ``unet_deep``
        left in its output."""
        self._x.copy_(x)
        self._t.fill_(t)
        self._replay(_UNET_GRAPH[kind])
        return self._out[kind]

    @torch.inference_mode()
    def generate_latents(self, prompts: Sequence[str],
                         negative_prompts: Optional[Sequence[str]] = None,
                         seed: int = 0,
                         guidance_scale: Optional[float] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """fp32 latents [batch, C, h, w].  ``noise`` replaces the draw
        from the seeded generator (JAX's ``key_data``)."""
        n = self.meta["batch"]
        if len(prompts) != n:
            raise ValueError(
                f"artifact was exported for batch {n}, got {len(prompts)} "
                "prompts (batch is static in an AOT program)")
        negs = (list(negative_prompts) if negative_prompts
                else [""] * n)
        if len(negs) != n:
            raise ValueError(f"negative_prompts ({len(negs)}) must match "
                             f"prompts ({n})")
        ids_l, ids_g = self.tokenizers(list(prompts) + negs)
        self.model._check_token_ids(torch.as_tensor(np.asarray(ids_l)),
                                    torch.as_tensor(np.asarray(ids_g)))
        g = float(self.meta["default_guidance_scale"] if guidance_scale
                  is None else guidance_scale)
        pe, pooled = self._encode(ids_l, ids_g)
        unet = (self._unet if self.graphs
                else self.sampler._unet_call(pe, pooled, self._time_ids))
        return self.sampler.sample_latents(
            unet, self.lat_shape, guidance_scale=g,
            num_steps=self.meta["num_inference_steps"],
            noise=None if noise is None else noise.to(self.device),
            generator=torch.Generator(device=self.device).manual_seed(seed),
            device=self.device)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> List[np.ndarray]:
        """Latents -> HWC uint8 images."""
        if self.graphs:
            self._latents.copy_(latents)
            self._replay("decode")
            images = self._images
        else:
            images = self._decode_fn(latents.to(self.device))
        return list(images.cpu().numpy())

    def __call__(self, prompts: Sequence[str],
                 negative_prompts: Optional[Sequence[str]] = None,
                 seed: int = 0, guidance_scale: Optional[float] = None,
                 noise: Optional[torch.Tensor] = None) -> List[np.ndarray]:
        return self.decode(self.generate_latents(
            prompts, negative_prompts, seed, guidance_scale, noise))
