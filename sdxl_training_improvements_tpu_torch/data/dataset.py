"""Aspect-bucketed dataset + precompute stage (host-side).

Port of ``sdxl_training_improvements_tpu/data/dataset.py``: preprocessing
is a host-side stage (``precompute``) that consumes encoder functions,
writes the latent cache, and training batches are pure cache reads
(numpy), stacked on the host and copied to the card by
``data/pipeline.py``.  The differences from the JAX package:

* images are read by ``images.py`` (the card's machine has no Pillow;
  the JAX package decodes with PIL) to the bits Pillow gives: JPEG (what
  libjpeg-turbo reads: Huffman, arithmetic and lossless frames, damaged
  streams), PNG and WebP (lossy, lossless, the first frame of an
  animation).  An image's size comes from the cache's metadata, or else
  from its header.  The bucketing skips, as JAX skips, a file that
  Pillow's ``Image.open`` refuses too (``images.ImageRefused``: a JPEG
  header it cannot identify, a WebP container libwebp refuses, an image
  past the decompression-bomb limit) or that cannot be opened, and the
  log names the file and the reader's reason; a file of a format the
  port does not read and Pillow may (``images.UnsupportedImage``: a GIF,
  BMP or TIFF, whatever its name) raises there, naming it, since JAX
  trains on it.  A file that fails to decode in the precompute is
  skipped, as JAX skips it, and the log names the reader's reason;
* ``prepare_image_array`` takes the decoded uint8 RGB array and runs the
  native C++ path (``native/image_ops.cpp``, the JAX package's code) with
  no PIL fallback: a failed build raises;
* ``create_dataset`` takes ``process_count`` / ``process_index`` (the
  ranks, and this one): a ``partitioned`` cache over several ranks puts
  each rank's cache under ``host-NNN`` and deals it a static share of the
  dataset (``partition_for_host``).

Batch contract matches the reference trainers (``ddpm_trainer.py:284-296``):
``vae_latents`` [B,C,h,w], ``prompt_embeds`` [B,77,2048],
``pooled_prompt_embeds`` [B,1280], ``time_ids`` [B,6], plus optional
``tag_weights`` [B].
"""
from __future__ import annotations

import collections
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sdxl_training_improvements_tpu_torch import native
from sdxl_training_improvements_tpu_torch.data.buckets import (
    Bucket, assign_bucket, generate_buckets)
from sdxl_training_improvements_tpu_torch.data.cache import CacheManager
from sdxl_training_improvements_tpu_torch.data.paths import load_data_from_directory
from sdxl_training_improvements_tpu_torch.data.samplers import BucketBatchSampler
from sdxl_training_improvements_tpu_torch.data.tags import (
    TagWeighter, create_tag_weighter_with_index)
from sdxl_training_improvements_tpu_torch.images import (
    ImageRefused, read_image_size, read_rgb)


def prepare_image_array(rgb: np.ndarray, bucket: Bucket,
                        center_crop: bool = True, flip: bool = False,
                        rng: Optional[np.random.Generator] = None
                        ) -> Tuple[np.ndarray, Tuple[int, int],
                                   Tuple[int, int]]:
    """uint8 HWC RGB -> float32 CHW in [-1, 1] at bucket dims, plus
    (original_size, crop_top_left) for SDXL conditioning
    (reference ``_prepare_image_tensor`` ``dataset.py:494-525`` +
    ``_compute_time_ids`` ``:378-392``).

    ``rng`` drives the random crop when ``center_crop=False`` -- callers
    wanting reproducible precompute MUST pass a seeded generator (the
    global np.random fallback is neither seeded nor thread-deterministic).
    """
    orig_h, orig_w = rgb.shape[:2]
    tw, th = bucket.width, bucket.height
    # scale preserving aspect so the short side covers the target, then crop
    scale = max(tw / orig_w, th / orig_h)
    rw, rh = max(tw, int(round(orig_w * scale))), max(th, int(round(orig_h * scale)))
    if center_crop:
        left = (rw - tw) // 2
        top = (rh - th) // 2
    else:
        r = rng if rng is not None else np.random.default_rng()
        left = int(r.integers(0, rw - tw + 1))
        top = int(r.integers(0, rh - th + 1))
    # Lanczos resize + crop + flip + normalize in C++
    arr = native.prepare_image_native(rgb, th, tw, top, left, rh, rw,
                                      flip=flip)
    return arr, (orig_h, orig_w), (top, left)


def compute_time_ids(original_size: Tuple[int, int],
                     crop_top_left: Tuple[int, int],
                     target_size: Tuple[int, int]) -> np.ndarray:
    """[6] = (orig_h, orig_w, crop_t, crop_l, tgt_h, tgt_w)."""
    return np.array([*original_size, *crop_top_left, *target_size],
                    dtype=np.float32)


class AspectBucketDataset:
    """Bucketed dataset over (image_path, caption) pairs with a latent cache."""

    def __init__(self, config, image_paths: Sequence[str],
                 captions: Sequence[str],
                 cache_manager: Optional[CacheManager] = None,
                 tag_weighter: Optional[TagWeighter] = None,
                 buckets: Optional[List[Bucket]] = None):
        assert len(image_paths) == len(captions)
        self.config = config
        self.image_paths = list(image_paths)
        self.captions = list(captions)
        self.cache = cache_manager
        self.tag_weighter = tag_weighter
        self.buckets = buckets if buckets is not None else generate_buckets(config)
        self._bucket_of: Dict[int, Bucket] = {}
        self.bucket_indices: Dict[Tuple[int, int], List[int]] = {}
        # per-instance stats, filled by precompute() (the BASELINE
        # latent-cache imgs/sec metric); always present for callers
        self.last_precompute_stats = {"images": 0, "seconds": 0.0,
                                      "images_per_sec": 0.0}
        self._assign_all()

    # ----------------------------------------------------------- assignment
    def _image_size(self, idx: int) -> Optional[Tuple[int, int]]:
        """(w, h) from cache metadata if present, else the image's header
        (cache-first like reference ``group_images_by_bucket``).  None,
        logged, for a file Pillow refuses too or that cannot be opened
        (JAX's ``Image.open`` raises there); a file of a format the port
        does not read raises, naming it."""
        path = self.image_paths[idx]
        if self.cache is not None:
            entry = self.cache.cached_entry(path)
            if entry and "original_size" in entry:
                h, w = entry["original_size"]
                return (w, h)
        try:
            return read_image_size(path)
        except (ImageRefused, OSError) as e:
            import logging
            logging.getLogger(__name__).warning(
                "bucketing: skipping %s, which Pillow refuses too: %s",
                path, e)
            return None

    def _assign_all(self) -> None:
        # header reads are I/O-bound; a thread pool turns the cold-start
        # serial scan (the reference's per-image header read,
        # ``bucket_utils.py:220-221``) into a parallel sweep.  Results are
        # consumed in index order so assignment stays deterministic.
        import os as _os
        from concurrent.futures import ThreadPoolExecutor
        n = len(self.image_paths)
        if n == 0:
            return
        workers = min(16, max(1, _os.cpu_count() or 4))
        with ThreadPoolExecutor(workers) as pool:
            sizes = list(pool.map(self._image_size, range(n)))
        for i, size in enumerate(sizes):
            if size is None:
                continue
            b = assign_bucket(size, self.buckets)
            if b is None:
                continue
            self._bucket_of[i] = b
            lw, lh = b.latent_dims
            self.bucket_indices.setdefault((lh, lw), []).append(i)

    def __len__(self) -> int:
        return len(self.image_paths)

    # ----------------------------------------------------------- precompute
    def precompute(self, encode_images: Callable, encode_prompts: Callable,
                   batch_size: int = 8, center_crop: bool = True,
                   random_flip: bool = False, seed: int = 0,
                   num_workers: Optional[int] = None,
                   serial: bool = False) -> int:
        """Encode all uncached images through the supplied device functions.

        ``encode_images(pixels_f32_nchw) -> latents``;
        ``encode_prompts(list[str]) -> {prompt_embeds, pooled_prompt_embeds}``.
        Batches are bucket-homogeneous.  Returns number of newly cached items.
        (Reference ``_precompute_latents`` ``dataset.py:403-492`` — including
        its caption-misalignment defect fix: captions are looked up by index,
        never zipped against a filtered list.)

        Three-stage host pipeline (the reference decodes serially,
        ``dataset.py:422-446``): a thread pool decodes/resizes images
        (the C++ unfilter and resize release the GIL), the main thread
        runs the encoders
        batch-after-batch (device stays fed), and a writer pool streams npz
        cache writes (``save_latents`` is lock-protected).  Measured rate is
        recorded on ``self.last_precompute_stats`` (the BASELINE
        "latent-cache imgs/sec" metric; reference logged rate/ETA at
        ``cache_manager.py:265-279``).

        ``num_workers`` sets the decode threads (default min(16, CPUs)).
        ``serial=True`` disables every overlap (one decode thread, no
        read-ahead, writes drained after each chunk): the reference's
        serial decode->encode->write loop, the A/B baseline of
        ``tools/bench_precompute.py``.
        """
        if self.cache is None:
            raise ValueError("precompute requires a CacheManager")
        import os as _os
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        todo_by_bucket: Dict[Tuple[int, int], List[int]] = {}
        for key, idxs in self.bucket_indices.items():
            todo = [i for i in idxs
                    if not self.cache.is_cached(self.image_paths[i])]
            if todo:
                todo_by_bucket[key] = todo

        total = sum(len(v) for v in todo_by_bucket.values())
        done = 0
        flip_rng = np.random.default_rng(seed)
        # flip decisions up front, in deterministic index order
        flips = {}
        for idxs in todo_by_bucket.values():
            for i in idxs:
                flips[i] = bool(random_flip and flip_rng.random() < 0.5)

        # per-stage wall time (list.append is GIL-atomic): decode_cpu sums
        # actual in-thread decode/resize seconds; encode/decode_wait are
        # accumulated in _encode_and_write.  Summed into
        # last_precompute_stats so the BASELINE "latent-cache imgs/sec"
        # number ships with its stage breakdown (the single-core bound is
        # decode_cpu-dominated on a 1-core host).
        self._stage_decode_s: List[float] = []
        self._stage_encode_s = self._stage_wait_s = 0.0

        def decode_one(i: int):
            b = self._bucket_of[i]
            t_dec = _time.perf_counter()
            try:
                rgb = read_rgb(self.image_paths[i])
                # per-image generator seeded by (seed, index): crops are
                # reproducible regardless of decode-thread scheduling
                arr, orig, crop = prepare_image_array(
                    rgb, b, center_crop=center_crop, flip=flips[i],
                    rng=np.random.default_rng((seed, i)))
            except (OSError, ValueError) as e:  # skipped, as JAX does
                import logging
                logging.getLogger(__name__).warning(
                    "precompute: skipping %s, which the image reader "
                    "refuses: %s", self.image_paths[i], e)
                return None
            finally:
                self._stage_decode_s.append(_time.perf_counter() - t_dec)
            tids = compute_time_ids(orig, crop, (b.height, b.width))
            meta = {"original_size": list(orig),
                    "crop_top_left": list(crop),
                    "target_size": [b.height, b.width],
                    "caption": self.captions[i]}
            return i, arr, tids, meta

        chunks = [idxs[s:s + batch_size]
                  for idxs in todo_by_bucket.values()
                  for s in range(0, len(idxs), batch_size)]
        workers = num_workers or min(16, (_os.cpu_count() or 4))
        ahead = 2  # decode runs ahead of the device by up to 2 chunks
        max_pending_writes = 256  # backpressure: each future pins a chunk
        if serial:
            workers, ahead, max_pending_writes = 1, 0, 0
        t0 = _time.perf_counter()
        write_futures = []

        def drain_writes(limit: int) -> None:
            while len(write_futures) > limit:
                write_futures.pop(0).result()
        with ThreadPoolExecutor(workers) as decode_pool, \
                ThreadPoolExecutor(1 if serial else 4) as write_pool:
            pending = collections.deque()
            for c, chunk in enumerate(chunks):
                pending.append([decode_pool.submit(decode_one, i)
                                for i in chunk])
                if len(pending) <= ahead and c < len(chunks) - 1:
                    continue
                futs = pending.popleft()
                done += self._encode_and_write(
                    futs, encode_images, encode_prompts, write_pool,
                    write_futures)
                drain_writes(max_pending_writes)
            while pending:
                futs = pending.popleft()
                done += self._encode_and_write(
                    futs, encode_images, encode_prompts,
                    write_pool, write_futures)
                drain_writes(max_pending_writes)
            drain_writes(0)  # surface writer errors
        elapsed = max(_time.perf_counter() - t0, 1e-9)
        self.last_precompute_stats = {
            "images": done, "seconds": elapsed,
            "images_per_sec": done / elapsed if done else 0.0,
            # stage breakdown (seconds): decode_cpu = summed in-thread
            # decode/resize time (overlappable across N cores);
            # encode_device = main-thread encode time;
            # decode_wait = main-thread time blocked on decode futures
            # (0 when the decode pool keeps ahead of the device)
            "stage_decode_cpu_s": round(sum(self._stage_decode_s), 3),
            "stage_encode_device_s": round(self._stage_encode_s, 3),
            "stage_decode_wait_s": round(self._stage_wait_s, 3),
        }
        if done:
            import logging
            logging.getLogger(__name__).info(
                "precompute: %d images in %.1fs (%.2f imgs/sec, %d decode "
                "workers)", done, elapsed, done / elapsed, workers)
        return self._finish_precompute(encode_prompts, total, done)

    def _encode_and_write(self, futures, encode_images, encode_prompts,
                          write_pool, write_futures) -> int:
        """Drain one chunk's decode futures, encode on device, queue cache
        writes.  Returns the number of images handled."""
        import time as _time
        arrs, tids_list, metas, caps, ok_idx = [], [], [], [], []
        t_wait = _time.perf_counter()
        for f in futures:
            out = f.result()
            if out is None:
                continue
            i, arr, tids, meta = out
            arrs.append(arr)
            tids_list.append(tids)
            metas.append(meta)
            caps.append(meta["caption"])
            ok_idx.append(i)
        self._stage_wait_s += _time.perf_counter() - t_wait
        if not arrs:
            return 0
        pixels = np.stack(arrs)
        t_enc = _time.perf_counter()
        latents = np.asarray(encode_images(pixels))
        self._stage_encode_s += _time.perf_counter() - t_enc
        enc = encode_prompts(caps)
        pe = np.asarray(enc["prompt_embeds"])
        pooled = np.asarray(enc["pooled_prompt_embeds"])

        def write(j, i):
            self.cache.save_latents(
                self.cache.get_cache_key(self.image_paths[i]),
                vae_latents=latents[j], time_ids=tids_list[j],
                prompt_embeds=pe[j], pooled_prompt_embeds=pooled[j],
                metadata=metas[j])

        for j, i in enumerate(ok_idx):
            write_futures.append(write_pool.submit(write, j, i))
        return len(ok_idx)

    def _finish_precompute(self, encode_prompts, total: int, done: int) -> int:
        # cache the empty-prompt embedding once for CFG caption dropout
        # (reference encode_prompt's proportion_empty_prompts, clip.py:52-54);
        # only when absent — re-encoding on every warm restart wastes a
        # text-encoder call
        if self.cache.load_empty_prompt() is None:
            enc = encode_prompts([""])
            self.cache.save_empty_prompt(
                np.asarray(enc["prompt_embeds"])[0],
                np.asarray(enc["pooled_prompt_embeds"])[0])
        self.cache.flush()
        return done

    # -------------------------------------------------------------- batches
    def get_batch(self, indices: Sequence[int],
                  proportion_empty_prompts: float = 0.0,
                  rng: Optional[np.random.Generator] = None
                  ) -> Optional[Dict[str, np.ndarray]]:
        """Stack cached tensors for a bucket-homogeneous index list.

        ``proportion_empty_prompts`` randomly swaps conditioning rows for the
        cached empty-prompt embedding (classifier-free-guidance dropout —
        the reference's encode-time option, ``clip.py:52-54``, moved to
        batch time so it works with cached embeddings).
        """
        if self.cache is None:
            raise ValueError("get_batch requires a CacheManager")
        items = []
        caps = []
        for i in indices:
            data = self.cache.load_latents(
                self.cache.get_cache_key(self.image_paths[i]))
            if data is None or "prompt_embeds" not in data:
                continue  # reference collate drops invalid items
            items.append(data)
            caps.append(self.captions[i])
        if not items:
            return None
        batch = {
            "vae_latents": np.stack([d["vae_latents"] for d in items]),
            "prompt_embeds": np.stack([d["prompt_embeds"] for d in items]),
            "pooled_prompt_embeds": np.stack(
                [d["pooled_prompt_embeds"] for d in items]),
            "time_ids": np.stack([d["time_ids"] for d in items]),
        }
        if proportion_empty_prompts > 0:
            empty = self._empty_prompt_cached()
            if empty is not None:
                rng = rng or np.random.default_rng()
                drop = rng.random(len(items)) < proportion_empty_prompts
                batch["prompt_embeds"][drop] = empty["prompt_embeds"]
                batch["pooled_prompt_embeds"][drop] = \
                    empty["pooled_prompt_embeds"]
        if self.tag_weighter is not None:
            batch["tag_weights"] = self.tag_weighter.get_batch_weights(caps)
        return batch

    def _empty_prompt_cached(self):
        """Memoised empty-prompt embedding — it is immutable for the run,
        and reading the npz per batch would put disk I/O in the hot input
        loop."""
        if getattr(self, "_empty_prompt_memo", None) is None:
            # retry while absent: precompute may write it after the first
            # get_batch (miss is a cheap Path.exists)
            self._empty_prompt_memo = self.cache.load_empty_prompt()
        return self._empty_prompt_memo

    def make_sampler(self, batch_size: int, seed: int = 0, shuffle: bool = True,
                     num_shards: int = 1, shard: int = 0) -> BucketBatchSampler:
        return BucketBatchSampler(self.bucket_indices, batch_size,
                                  shuffle=shuffle, seed=seed,
                                  num_shards=num_shards, shard=shard)

    def partition_for_host(self, num_shards: int, shard: int
                           ) -> "AspectBucketDataset":
        """Static per-rank partition for the partitioned-cache layout
        (``global_config.cache.partitioned``; JAX ``dataset.py:410-456``,
        one rank being JAX's one process).

        Each bucket's index list is truncated to a multiple of
        ``num_shards`` and dealt round-robin, so every rank holds exactly
        ``len(bucket) // num_shards`` images per bucket.  The assignment is
        static across epochs (an image lives where it was precomputed);
        shuffling happens per epoch within the rank's share.  In place;
        returns self; a second call with another partition raises."""
        if num_shards <= 1:
            return self
        if getattr(self, "_partition", None) is not None:
            if self._partition != (num_shards, shard):
                raise ValueError(
                    f"dataset already partitioned as {self._partition}, "
                    f"cannot re-partition as {(num_shards, shard)}")
            return self
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} not in [0, {num_shards})")
        dropped = 0
        new: Dict[Tuple[int, int], List[int]] = {}
        for key in sorted(self.bucket_indices):
            idxs = self.bucket_indices[key]
            keep = (len(idxs) // num_shards) * num_shards
            dropped += len(idxs) - keep
            sel = idxs[shard:keep:num_shards]
            if sel:
                new[key] = sel
        self.bucket_indices = new
        self._partition = (num_shards, shard)
        if dropped:
            import logging
            logging.getLogger(__name__).warning(
                "partition_for_host: %d images dropped to equalize "
                "per-host bucket counts across %d hosts", dropped,
                num_shards)
        return self


def create_dataset(config, cache_manager: Optional[CacheManager] = None,
                   tag_weighter: Optional[TagWeighter] = None,
                   data_dir=None, process_count: int = 1,
                   process_index: int = 0) -> AspectBucketDataset:
    """Directory scan -> dataset (reference ``create_dataset``
    ``dataset.py:670-698``).  ``data_dir`` overrides
    ``config.data.train_data_dir`` (used for the held-out
    ``data.validation_data_dir`` dataset).

    Cache placement policy (``global_config.cache``):

    * ``persistent`` knobs all true -> ``cache_dir`` as configured;
    * any persistence knob false (the reference's cache-less mode) -> an
      ephemeral per-run temp directory deleted at interpreter exit
      (precompute still runs — see ``CacheConfig.persistent``);
    * ``partitioned`` true with ``process_count`` > 1 -> the rank's own
      subdirectory ``host-NNN`` (NNN = ``process_index``) and, for the
      train set, its static share of the dataset (``partition_for_host``),
      so each rank encodes and reads only its own entries.
    """
    cache_cfg = config.global_config.cache
    is_train = data_dir is None
    partitioned = cache_cfg.partitioned and process_count > 1
    image_paths, captions = load_data_from_directory(
        data_dir if data_dir is not None else config.data.train_data_dir)
    if cache_manager is None:
        if cache_cfg.persistent:
            cache_root = Path(cache_cfg.cache_dir)
        else:
            import atexit
            import shutil
            import tempfile
            ephemeral = tempfile.mkdtemp(prefix="sdxl_tpu_ephemeral_cache_")
            atexit.register(shutil.rmtree, ephemeral, ignore_errors=True)
            import logging
            logging.getLogger(__name__).warning(
                "cache persistence disabled (use_cache/cache_latents/"
                "cache_text_embeddings false): precompute still runs, into "
                "an ephemeral per-run cache at %s (deleted at exit). "
                "Crops/flips are fixed for the run, not re-rolled per "
                "epoch as the reference's __getitem__ encoding would.",
                ephemeral)
            cache_root = Path(ephemeral)
        if partitioned:
            cache_root = cache_root / f"host-{process_index:03d}"
        cache_manager = CacheManager(cache_root)
    if tag_weighter is None:
        tag_weighter = create_tag_weighter_with_index(config, captions,
                                                      cache_manager)
    ds = AspectBucketDataset(config, image_paths, captions, cache_manager,
                             tag_weighter)
    if is_train and partitioned:
        ds.partition_for_host(process_count, process_index)
    return ds
