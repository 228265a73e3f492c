"""Training orchestration: config -> model -> data -> train loop.

Port of ``sdxl_training_improvements_tpu/training/loop.py``:
``SDXLTrainer`` wires the model, the cached dataset, the optimizer and
``make_train_step``, runs epochs with logging, held-out validation loss,
validation images and checkpoints at epoch ends, and resumes from a
checkpoint (``--resume``).  The epoch arithmetic and the checkpoint
cadence are the JAX package's.  The differences:

* one card per process, ``device=`` (the card unless the caller asks for
  the CPU); over several processes (torchrun, or JAX's env triple;
  ``parallel/mesh.py`` ``initialize_multihost``) rank r trains on
  ``cuda:LOCAL_RANK`` over ``tpu.mesh_shape`` (default: every rank on
  ``data``), with JAX's multi-process parts (``loop.py:63-78``,
  ``:325-345``, ``:415-425``, ``:476-499``, ``:549-589``): the
  micro-batch divisibility check, the pre-train barrier, the partitioned
  cache's per-rank rows, the validation loss agreed over the ranks (a
  failure anywhere: None everywhere), every rank calling the saves and
  rank 0 alone writing ``trainer_state.json``, the exports and the
  validation images.  A tensor axis above 1 splits the UNet's
  transformer blocks megatron-style (``shard_train_state(..., unet=)``):
  every rank samples the validation images then (the UNet's forward is a
  collective) and the exports gather the slices.  Under
  ``tpu.shard_params`` each rank stores only its fsdp chunk of the large
  leaves (``parallel/zero.py`` ``store_params``): the validation loss,
  the validation images and the exports run on the chunks gathered over
  fsdp by every rank (``Zero.holding``);
* LoRA (``training.lora.enabled``, JAX ``:97-126``): the trainable tree
  is the pairs (``models/lora.py``), the frozen UNet goes to the step as
  ``const_params``; checkpoints ship the adapter (``export_lora``) and
  the merged UNet.  The tensor axis splits nothing under LoRA: JAX's
  ``TP_RULES`` match no LoRA path and the frozen base is not placed
  (JAX ``:126``), so every tensor rank runs the whole UNet;
* the weights to evaluate and export (``eval_params``) are the EMA
  shadow, else schedule-free's x, else the parameters; validation images
  and the diffusers export use them (LoRA: merged into the base);
* the precompute runs the port's VAE encoder and CLIPs under
  ``torch.no_grad``, the VAE's sample drawn from a generator seeded with
  ``training.seed``;
* loss values stay on the device and are read at ``log_every`` and at
  the epoch's end only;
* on a card, cuDNN is held to deterministic algorithms while the trainer
  precomputes and trains, so that a resumed run repeats the uninterrupted
  one bit for bit (XLA is deterministic where cuDNN's default algorithms
  are not); the process's own settings come back when those calls return.
"""
from __future__ import annotations

import contextlib
import json
import math
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch

from sdxl_training_improvements_tpu_torch.core.logging import (
    LogConfig, UnifiedLogger, setup_logging)
from sdxl_training_improvements_tpu_torch.core.profiling import (
    ThroughputMonitor, device_memory_stats, profiler_trace)
from sdxl_training_improvements_tpu_torch.data.dataset import (
    AspectBucketDataset, create_dataset)
from sdxl_training_improvements_tpu_torch.data.pipeline import (
    adapt_time_ids_iter, batches_for_epoch, check_shard_integrity,
    prefetch_to_device)
from sdxl_training_improvements_tpu_torch.models.base import (
    TimestepBiasStrategy)
from sdxl_training_improvements_tpu_torch.models.lora import (
    DEFAULT_TARGETS, lora_merge, lora_train_wrappers)
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.tokenizer import (
    TokenizerPair, load_tokenizers)
from sdxl_training_improvements_tpu_torch.parallel import mesh as M
from sdxl_training_improvements_tpu_torch.training import checkpoints as C
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    EMAState, ScheduleFreeKahanState, ema_eval_params, make_optimizer,
    schedule_free_eval_params)
from sdxl_training_improvements_tpu_torch.training.schedules import (
    NoiseSchedule)
from sdxl_training_improvements_tpu_torch.training.trainer import (
    create_train_state, make_train_step, shard_train_state)

COMPONENTS = frozenset({"unet", "vae", "clip_l", "clip_g"})


@contextmanager
def deterministic_convolutions(device: torch.device):
    """cuDNN's deterministic algorithms (and no autotuning) on a card for
    the body, the caller's settings restored after it."""
    cudnn = torch.backends.cudnn
    if device.type != "cuda":
        yield
        return
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


class SDXLTrainer:
    def __init__(self, config, model: Optional[SDXLModel] = None,
                 dataset: Optional[AspectBucketDataset] = None,
                 logger: Optional[UnifiedLogger] = None,
                 output_dir: str = "outputs", device="cuda"):
        self.config = config
        self.output_dir = Path(output_dir)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda': torch.cuda.is_available() is False (no "
                "card); pass device='cpu' (--device cpu) to train on the "
                "CPU")
        M.initialize_multihost(self.device.type)
        if self.device.type == "cuda" and M.process_count() > 1:
            self.device = torch.device("cuda", M.local_rank())
        lc = config.global_config.logging
        self.logger = logger or setup_logging(LogConfig(
            log_dir=lc.log_dir, filename=lc.filename,
            console_level=lc.console_level, file_level=lc.file_level,
            capture_warnings=lc.capture_warnings, use_wandb=lc.use_wandb,
            wandb_project=lc.wandb_project, wandb_entity=lc.wandb_entity,
            log_every=lc.log_every))

        shape = config.tpu.mesh_shape
        self.mesh = None  # one process: the meshless step (JAX use_mesh)
        if torch.distributed.is_initialized() or (
                shape is not None and math.prod(shape) > 1):
            self.mesh = M.mesh_from_config(config, self.device.type)
            sizes = M.axis_sizes(self.mesh)
            dp = sizes[M.DATA_AXIS] * sizes[M.FSDP_AXIS]
            micro = (config.tpu.micro_batch_size
                     or config.training.batch_size)
            if micro % dp:
                raise ValueError(
                    f"the micro-batch size ({micro} = "
                    f"tpu.micro_batch_size or training.batch_size) "
                    f"must be divisible by the data-parallel mesh extent "
                    f"({dp} = data {sizes[M.DATA_AXIS]} x fsdp "
                    f"{sizes[M.FSDP_AXIS]}): each micro-batch is "
                    "sharded over those axes. Raise batch_size or shrink "
                    "tpu.mesh_shape.")

        # ----- model
        if model is None:
            model = self._load_model()
        self.model = model
        self.tokenizers = self._load_tokenizers()

        # fail fast on a bad bias-strategy string (the enum is the public
        # config surface, reference ``models/base.py:33-38``)
        TimestepBiasStrategy.from_str(config.model.timestep_bias_strategy)

        # ----- schedule / optimizer / step
        self.schedule = NoiseSchedule.from_config(config)
        self.optimizer = make_optimizer(config)

        # LoRA: the trainable tree becomes the pairs and the step applies
        # them to the frozen base, which rides the step as const_params
        lcfg = config.training.lora
        self.lora_apply = None
        step_consts = None
        if lcfg.enabled:
            trainable, apply_fn = lora_train_wrappers(
                self.model, torch.Generator(device=self.device).manual_seed(
                    config.training.seed + 1),
                rank=lcfg.rank, alpha=lcfg.alpha,
                targets=tuple(lcfg.targets) if lcfg.targets
                else DEFAULT_TARGETS, dropout=lcfg.dropout)
            self.lora_apply = apply_fn
            step_consts = self.model.trainable_params()
            # validation_loss evaluates the adapter as trained
            self._apply_fn = lambda *a, **k: apply_fn(
                self.state.params, *a, base_params=step_consts, **k)
        else:
            trainable = self.model.trainable_params()
            apply_fn = self._apply_fn = self.model.unet_apply
        self.train_step = make_train_step(apply_fn, self.schedule,
                                          self.optimizer, config,
                                          const_params=step_consts,
                                          mesh=self.mesh)

        # ----- state (fresh or resumed)
        state = create_train_state(trainable, self.optimizer,
                                   seed=config.training.seed)
        resume = config.training.resume_from
        self.best_loss = float("inf")
        if resume == "auto":
            ckpt = C.latest_checkpoint(self.output_dir)
        elif resume:
            ckpt = Path(resume)
            if not (ckpt / "state").exists():
                # an explicit resume target must not silently fall through
                # to a fresh run that overwrites the output dir
                raise FileNotFoundError(
                    f"training.resume_from={str(ckpt)!r} has no 'state' "
                    "subdirectory (not a checkpoint of this framework). "
                    "Fix the path, or use resume_from: 'auto' to pick the "
                    "latest checkpoint / start fresh.")
        else:
            ckpt = None
        self.restore_seconds = None
        if ckpt is not None and (Path(ckpt) / "state").exists():
            t0 = time.perf_counter()
            state = C.restore_train_state(ckpt, state)
            self.restore_seconds = time.perf_counter() - t0
            self.logger.info(f"Resumed from {ckpt} at step {state.step} "
                             f"({self.restore_seconds:.2f} s)")
            meta = Path(ckpt) / "trainer_state.json"
            if meta.exists():  # restore best-loss tracking across restarts
                try:
                    self.best_loss = float(
                        json.loads(meta.read_text())["best_loss"])
                except (OSError, ValueError, KeyError) as e:
                    self.logger.warning(f"{meta}: best_loss not read: {e}")
        if self.mesh is not None:  # the one-card state, cut to this rank's
            state = shard_train_state(
                state, self.mesh, config.tpu.shard_params,
                unet=None if lcfg.enabled else self.model.unet)
        self.state = state

        self.dataset = dataset
        global_batch = (config.training.batch_size
                        * max(1, config.training.gradient_accumulation_steps))
        self.throughput = ThroughputMonitor(batch_size=global_batch)
        self.last_save: Dict[str, float] = {}

    # ------------------------------------------------------------ builders
    def _load_model(self) -> SDXLModel:
        """``SDXLModel.from_config``: a local diffusers checkpoint in
        ``model.pretrained_model_name`` (its declared topology; an
        inpainting one raises), else seeded weights (seed 0 on the run's
        device)."""
        name = self.config.model.pretrained_model_name
        model = SDXLModel.from_config(
            self.config, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(0))
        ucfg = model.unet_config
        if model.imported is not None:
            self.logger.info(
                f"Loaded pretrained SDXL from {name}: "
                f"{sorted(model.imported)}; UNet in_channels="
                f"{ucfg.in_channels}, stages={ucfg.block_out_channels}, "
                f"time_ids={ucfg.num_time_ids}"
                + (" (refiner: single-encoder conditioning)"
                   if model.clip_l is None else ""))
        else:
            self.logger.warning(
                f"Pretrained path {name!r} not found locally - random init "
                "(training from scratch). Point model.pretrained_model_name "
                "at a diffusers-layout checkpoint directory for fine-tuning.")
        return model

    def _load_tokenizers(self) -> TokenizerPair:
        local = Path(self.config.model.pretrained_model_name)
        single = self.model.clip_l is None  # refiner: CLIP-G only
        if local.exists():
            return load_tokenizers(
                local, self.config.data.tokenizer_max_length,
                single_encoder=single,
                fallback_vocab_size=self.model.clip_g.cfg.vocab_size)
        # hash stand-in sized to the model's vocabulary
        return TokenizerPair.fallback(
            vocab_size=self.model.clip_g.cfg.vocab_size,
            max_length=self.config.data.tokenizer_max_length)

    def _components(self) -> frozenset:
        """The components that hold usable weights: those a checkpoint
        gave, or all of them when the weights are seeded."""
        return (COMPONENTS if self.model.imported is None
                else self.model.imported)

    # ---------------------------------------------------------------- data
    def prepare_data(self) -> AspectBucketDataset:
        """Dataset + latent/embedding precompute through the encoders."""
        if self.dataset is None:
            self.dataset = create_dataset(
                self.config, process_count=M.process_count(),
                process_index=M.process_index())
        self._precompute_into(self.dataset, label="train")
        return self.dataset

    def _precompute_into(self, ds: AspectBucketDataset,
                         label: str = "train") -> None:
        """Run latent/embedding precompute on ``ds`` through the encoders
        (no-op without a cache or the encoder weights)."""
        needed = {"vae", "clip_g"} | (
            set() if self.model.clip_l is None else {"clip_l"})
        if ds.cache is None or not needed <= self._components():
            return
        device = self.device
        gen = torch.Generator(device=device).manual_seed(
            self.config.training.seed)

        def enc_i(px):
            with torch.no_grad():
                lat = self.model.encode_images(
                    torch.from_numpy(px).to(device, torch.float32),
                    generator=gen)
            return lat.float().cpu().numpy()

        def enc_p(captions):
            ids_l, ids_g = self.tokenizers(captions)
            with torch.no_grad():
                out = self.model.encode_prompt(
                    None if self.model.clip_l is None else torch.as_tensor(
                        ids_l, dtype=torch.int64, device=device),
                    torch.as_tensor(ids_g, dtype=torch.int64, device=device))
            return {k: v.float().cpu().numpy() for k, v in out.items()}

        with deterministic_convolutions(device):
            n = ds.precompute(enc_i, enc_p,
                              batch_size=self.config.training.batch_size,
                              center_crop=self.config.data.center_crop,
                              random_flip=self.config.data.random_flip)
        stats = ds.last_precompute_stats
        self.logger.info(
            f"Precomputed {n} {label} latent/embedding entries "
            f"({stats['images_per_sec']:.2f} imgs/sec)")
        self.logger.log_metrics(
            {f"precompute/{label}_images_per_sec": stats["images_per_sec"],
             f"precompute/{label}_images": n}, step=0)

    def prepare_validation_data(self) -> Optional[AspectBucketDataset]:
        """Held-out dataset from ``data.validation_data_dir``, cached under
        ``<cache_dir>/validation`` so the train cache index never mixes
        with held-out entries.  Returns None when the knob is unset."""
        val_dir = self.config.data.validation_data_dir
        if not val_dir:
            return None
        if getattr(self, "val_dataset", None) is not None:
            return self.val_dataset
        from sdxl_training_improvements_tpu_torch.data.cache import (
            CacheManager)
        cache = None
        ccfg = self.config.global_config.cache
        # a persistent cache gets a validation/ subdirectory; without
        # persistence create_dataset builds the per-run cache (stale
        # held-out latents must never outlive the VAE weights that made
        # them: they drive best-checkpoint selection)
        if ccfg.persistent:
            cache = CacheManager(Path(ccfg.cache_dir) / "validation")
        self.val_dataset = create_dataset(self.config, cache_manager=cache,
                                          data_dir=val_dir)
        self._precompute_into(self.val_dataset, label="validation")
        return self.val_dataset

    # ---------------------------------------------------------------- train
    def train(self, num_epochs: Optional[int] = None) -> Dict[str, float]:
        cfg = self.config.training
        num_epochs = num_epochs or cfg.num_epochs
        ds = self.dataset or self.prepare_data()
        global_batch = cfg.batch_size * max(1, cfg.gradient_accumulation_steps)
        max_steps = cfg.max_steps
        # several ranks: under a shared cache every rank iterates the same
        # global batches; under a partitioned one each rank reads its
        # global_batch / ranks rows of every step (data/pipeline.py)
        nproc = M.process_count()
        partitioned = (self.config.global_config.cache.partitioned
                       and nproc > 1)
        if partitioned:
            if global_batch % nproc:
                raise ValueError(
                    f"partitioned cache: global batch ({global_batch}) must "
                    f"be divisible by process_count ({nproc}) — each host "
                    "contributes an equal row block per step.")
            sampler_batch = global_batch // nproc
        else:
            sampler_batch = global_batch
        val_ds = self.prepare_validation_data()  # per-rank work: pre-barrier
        # absorb the ranks' skew (precompute, first kernel builds) before
        # the first collective (parallel/mesh.py::barrier)
        M.barrier("sdxl-pre-train")
        per_epoch = check_shard_integrity(ds, sampler_batch, seed=cfg.seed)
        if per_epoch == 0:
            raise ValueError(
                f"No trainable batches: {len(ds)} images across "
                f"{len(ds.bucket_indices)} buckets with global batch size "
                f"{global_batch}. Check data.train_data_dir "
                f"({self.config.data.train_data_dir}) and batch size.")
        total_steps = max_steps or num_epochs * per_epoch
        metrics: Dict[str, torch.Tensor] = {}
        log_every = max(self.config.global_config.logging.log_every, 1)
        # resume: derive the completed-epoch count from the restored step so
        # finished epochs are not replayed
        step_count = int(self.state.step)
        start_epoch = min(step_count // per_epoch, num_epochs)
        num_time_ids = self.model.unet_config.num_time_ids

        with deterministic_convolutions(self.device), \
                profiler_trace(self.config.tpu.profile_dir):
            for epoch in range(start_epoch, num_epochs):
                if max_steps and step_count >= max_steps:
                    break  # e.g. resumed at/over the cap: run NO extra step
                epoch_losses = []  # device scalars; read at epoch end
                batch_iter = batches_for_epoch(
                    ds, sampler_batch, epoch=epoch, seed=cfg.seed,
                    proportion_empty_prompts=cfg.proportion_empty_prompts)
                if num_time_ids != 6:
                    # refiner fine-tune: 5-id aesthetic-score conditioning
                    batch_iter = adapt_time_ids_iter(
                        batch_iter, num_time_ids,
                        self.config.model.aesthetic_score)
                for batch in prefetch_to_device(batch_iter, self.device,
                                                local_rows=partitioned):
                    if max_steps and step_count >= max_steps:
                        break  # check BEFORE stepping, not after
                    self.throughput.start_batch()
                    self.state, metrics = self.train_step(self.state, batch)
                    step_count += 1
                    self.throughput.end_batch(global_batch)
                    epoch_losses.append(metrics["loss"])
                    # read device values only at the log boundary, so the
                    # host keeps queueing work between logs
                    if step_count % log_every == 0:
                        payload = {k: float(v) for k, v in metrics.items()}
                        payload.update(self.throughput.get_metrics())
                        payload.update(device_memory_stats())
                        payload["epoch"] = epoch
                        self.logger.log_metrics(payload, step=step_count)
                        self.logger.update_progress(step_count, total_steps,
                                                    n=log_every)
                    if max_steps and step_count >= max_steps:
                        break
                # ---- epoch end: checkpointing (reference cadence:
                # save_every epochs + best loss + final).  Every rank takes
                # the same branches (the losses are averaged over the
                # ranks): the saves are collectives
                epoch_loss = (float(torch.stack(epoch_losses).double().mean())
                              if epoch_losses else float("nan"))
                self.logger.info(f"Epoch {epoch}: mean loss {epoch_loss:.5f}")
                # held-out validation loss drives best-checkpoint selection
                # when present
                track_loss = epoch_loss
                if val_ds is not None:
                    vloss = self.run_validation_loss(val_ds)
                    if vloss is not None:
                        track_loss = vloss
                        self.logger.log_metrics({"val/loss": vloss},
                                                step=step_count)
                        self.logger.info(
                            f"Epoch {epoch}: validation loss {vloss:.5f}")
                if track_loss < self.best_loss:
                    self.best_loss = track_loss
                    if cfg.save_best:
                        self.save_checkpoint(tag="best")
                if cfg.save_every and (epoch + 1) % cfg.save_every == 0:
                    self.save_checkpoint(epoch=epoch)
                    self.run_validation_images()
                if max_steps and step_count >= max_steps:
                    break
        if cfg.save_final_model:
            self.save_checkpoint(tag="final")
        # join in-flight saves before returning: the caller may read the
        # checkpoint back (or exit the process) immediately
        t0 = time.perf_counter()
        C.wait_for_saves()
        M.barrier("sdxl-saves-joined")  # rank 0's files are on disk
        if self.last_save:
            self.last_save["join_s"] = time.perf_counter() - t0
            self.logger.info(f"Checkpoints on disk after another "
                             f"{self.last_save['join_s']:.2f} s")
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------- weights
    def eval_params(self) -> Mapping[str, torch.Tensor]:
        """Weights to evaluate/export.  Precedence: the fp32 EMA shadow
        when ``training.ema_decay`` is on; else schedule-free's averaged x
        sequence; else the parameters (under LoRA: the pairs).  With
        sharded optimizer state every rank calls it: the sharded leaves
        are formed on the chunks and gathered over fsdp (a split leaf to
        this rank's slice, as the placed UNet holds it)."""
        opt_state = self.state.opt_state
        zero = self.state.zero
        params = self.state.params
        view = params if zero is None else zero.views(params)
        # (EMA + schedule-free is refused by make_optimizer)
        if isinstance(opt_state, EMAState):
            out = ema_eval_params(opt_state, view)
        elif isinstance(opt_state, ScheduleFreeKahanState):
            out = schedule_free_eval_params(
                opt_state, view, beta1=self.config.optimizer.beta1)
        elif zero is not None and zero.stored:  # the stored chunks, gathered
            return zero.whole_params(params, whole=False)
        else:
            return params
        return out if zero is None else zero.gather_tensors(out,
                                                            whole=False)

    @contextmanager
    def evaluated_weights(self):
        """The UNet runs with ``eval_params`` for the body: under LoRA the
        adapter merges the evaluated pairs; otherwise each parameter's
        data is swapped for its evaluated tensor and swapped back after."""
        params = self.eval_params()
        if self.lora_apply is not None:
            with self.lora_apply.adapter.bound(params):
                yield
            return
        live = self.state.params
        zero = self.state.zero
        if zero is not None and zero.stored:  # the UNet's units gather not
            with zero.holding(live, params):
                yield
            return
        saved = {n: live[n].data for n in live if params[n] is not live[n]}
        try:
            for n in saved:
                live[n].data = params[n]
            yield
        finally:
            for n, d in saved.items():
                live[n].data = d

    def unet_export_state(self) -> Optional[Dict[str, torch.Tensor]]:
        """The UNet state dict to export when it is not the module's own:
        the merged LoRA, or the evaluated weights; None otherwise."""
        params = self.eval_params()
        zero = self.state.zero
        if self.lora_apply is not None:
            params = lora_merge(self.model.trainable_params(), params,
                                alpha=self.config.training.lora.alpha)
        elif zero is not None and zero.tp:  # the slices, gathered whole
            params = zero.whole_params(params, chunked=False)
        elif params is self.state.params:
            return None
        return {**self.model.unet.state_dict(), **params}

    # ----------------------------------------------------------- validation
    def run_validation_loss(self, val_ds: AspectBucketDataset
                            ) -> Optional[float]:
        """Held-out loss through ``training.validation.validation_loss``
        on the current parameters."""
        from sdxl_training_improvements_tpu_torch.training.validation import (
            validation_loss)
        zero, live = self.state.zero, self.state.params
        # stored fsdp chunks: gathered for the whole loss (a collective of
        # every rank, outside the guard below)
        with (zero.holding(live, zero.whole_params(live, whole=False))
              if zero is not None and zero.stored
              else contextlib.nullcontext()):
            try:
                vloss = validation_loss(
                    self._apply_fn, val_ds, self.schedule, self.config,
                    seed=self.config.training.seed + 17,
                    num_time_ids=self.model.unet_config.num_time_ids,
                    device=self.device)
            except Exception as e:  # never kill training over validation
                self.logger.warning(f"validation loss failed: {e}")
                vloss = None
        if M.process_count() == 1:
            return vloss
        # several ranks: the value gates a collective best-checkpoint save,
        # so every rank must hold the same one: a failure anywhere gives
        # None everywhere, else the mean over the ranks (JAX :476-499)
        M.barrier("val_loss_exchange")
        local = torch.tensor([float("nan") if vloss is None
                              else float(vloss)], dtype=torch.float64)
        gathered = [torch.zeros_like(local)
                    for _ in range(M.process_count())]
        torch.distributed.all_gather(gathered, local, group=M.host_group())
        values = torch.cat(gathered)
        if torch.isnan(values).any():
            if vloss is not None:
                self.logger.warning(
                    "validation loss failed on another host; skipping "
                    "val tracking this epoch on every host")
            return None
        return float(values.mean())

    def run_validation_images(self) -> None:
        """Sample ``data.validation_prompts`` and log images.  No-op
        without prompts or encoder/decoder weights."""
        prompts = self.config.data.validation_prompts
        if not prompts or not {"vae", "clip_l", "clip_g"} <= \
                self._components():
            return
        from sdxl_training_improvements_tpu_torch.training.validation import (
            ValidationLogger, ValidationSampler)
        method = self.config.training.method
        if method not in ("ddpm", "flow_matching"):
            # custom registry methods don't declare a sampler family
            self.logger.warning(
                f"no image sampler for custom method {method!r}; skipping "
                "validation images (val loss still runs)")
            return
        zero = self.state.zero
        # a UNet split over the tensor axis samples on every rank (its
        # forward is a collective); rank 0 writes the images
        split = zero is not None and bool(zero.tp)
        with self.evaluated_weights():  # a collective with sharded state
            if not (split or M.is_main_process()):
                return
            try:
                sampler = ValidationSampler(
                    self.model, self.tokenizers, self.schedule,
                    num_inference_steps=(
                        self.config.training.num_inference_steps),
                    method=method, mesh=self.mesh if split else None)
                size = self.config.data.image_size
                step = int(self.state.step)
                if not M.is_main_process():  # the collective, no files
                    sampler.generate(prompts, torch.Generator(
                        device=self.device).manual_seed(step), size, size)
                    return
                vl = ValidationLogger(sampler, prompts, self.output_dir,
                                      logger=self.logger, height=size,
                                      width=size)
                vl.run_validation(step)
            except Exception as e:  # sampling must never kill training
                self.logger.warning(f"validation sampling failed: {e}")

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, epoch: Optional[int] = None,
                        tag: Optional[str] = None) -> Path:
        """The train state (for ``--resume``; in the background under
        ``tpu.async_checkpointing``), ``trainer_state.json`` and the
        diffusers export of the current weights.  ``last_save`` holds its
        sizes and times.  Every rank calls it (the state's gather and the
        evaluated weights are collectives); rank 0 writes the files."""
        from sdxl_training_improvements_tpu_torch.training.checkpoints \
            import components
        name = (f"checkpoint-{epoch:04d}" if epoch is not None
                else f"{tag or 'final'}_checkpoint")
        path = self.output_dir / name
        self.logger.info(f"Saving checkpoint to {path}")
        t0 = time.perf_counter()
        C.wait_for_saves()  # at most one save in flight
        t1 = time.perf_counter()
        blocking = not self.config.tpu.async_checkpointing
        state_bytes = C.save_train_state(path, self.state, config=self.config,
                                         blocking=blocking)
        t2 = time.perf_counter()
        main = M.is_main_process()
        if main:
            (path / "trainer_state.json").write_text(json.dumps(
                {"best_loss": self.best_loss, "step": int(self.state.step)}))
        lora_tree = (self.eval_params() if self.lora_apply is not None
                     else None)
        unet_state = self.unet_export_state()
        export_bytes = 0
        if main:
            if lora_tree is not None:
                # ship the adapter (peft layout) and the merged UNet
                lcfg = self.config.training.lora
                C.export_lora(path, lora_tree, rank=lcfg.rank,
                              alpha=lcfg.alpha)
            export_bytes = C.export_diffusers(
                path, components(self.model), config=self.config,
                unet_config=self.model.unet_config, unet_state=unet_state,
                scheduler_config={
                    "prediction_type": self.config.training.prediction_type,
                    "num_train_timesteps": self.config.model.num_timesteps,
                    "sigma_min": self.config.model.sigma_min,
                    "sigma_max": self.config.model.sigma_max,
                    "use_ztsnr": self.config.model.use_ztsnr,
                })
        del unet_state, lora_tree
        t3 = time.perf_counter()
        gib = 2 ** 30
        self.last_save = {"state_gib": state_bytes / gib,
                          "export_gib": export_bytes / gib,
                          "wait_s": t1 - t0, "state_s": t2 - t1,
                          "export_s": t3 - t2}
        self.logger.info(
            f"Saved {path}: train state {state_bytes / gib:.2f} GiB "
            + ("snapshot to host memory, written in the background"
               if not blocking else "written")
            + f" in {t2 - t1:.2f} s (after {t1 - t0:.2f} s waiting for the "
            f"previous save), diffusers export {export_bytes / gib:.2f} GiB "
            f"in {t3 - t2:.2f} s")
        return path
