"""Host -> device input pipeline: per-bucket batching with a prefetched,
ordered copy to the card.

Port of ``sdxl_training_improvements_tpu/data/pipeline.py``.  Batches are
assembled on the host (numpy) in the JAX package's order, then copied to
the device ahead of the consumer, so the copy overlaps the previous train
step (JAX: ``jax.device_put`` with the batch sharding).  One process:
``check_shard_integrity`` keeps the single-process branch only
(multi-process runs are ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import logging
import queue as queue_mod
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def check_shard_integrity(dataset, batch_size: int, num_shards: int = 1,
                          shard: int = 0, seed: int = 0) -> int:
    """The per-epoch batch count (JAX ``check_shard_integrity`` with one
    process: there is nothing to exchange, and an entry missing from the
    cache only drops its batch, which ``batches_for_epoch`` logs)."""
    return len(dataset.make_sampler(batch_size, seed=seed,
                                    num_shards=num_shards, shard=shard))


def batches_for_epoch(dataset, batch_size: int, epoch: int = 0, seed: int = 0,
                      num_shards: int = 1, shard: int = 0,
                      proportion_empty_prompts: float = 0.0,
                      strict: Optional[bool] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side batch iterator (bucket-homogeneous, reference contract),
    in the JAX package's order: the sampler seeded by ``seed + epoch``,
    the caption dropout by ``seed * 100003 + epoch``.

    ``strict`` (default: on for multi-shard runs) turns a dropped
    ragged/invalid batch into an error."""
    sampler = dataset.make_sampler(batch_size, seed=seed,
                                   num_shards=num_shards, shard=shard)
    sampler.set_epoch(epoch)
    rng = np.random.default_rng(seed * 100003 + epoch)
    strict = (num_shards > 1) if strict is None else strict
    dropped = 0
    for indices in sampler:
        batch = dataset.get_batch(
            indices, proportion_empty_prompts=proportion_empty_prompts,
            rng=rng)
        if batch is None or batch["vae_latents"].shape[0] < batch_size:
            # drop ragged/invalid batches (uniform shapes per bucket)
            if strict:
                raise RuntimeError(
                    f"incomplete batch (epoch {epoch}, indices "
                    f"{list(indices)[:4]}…) in strict mode — refusing to "
                    "drop it. Run precompute / verify the cache.")
            dropped += 1
            continue
        yield batch
    if dropped:
        logging.getLogger(__name__).warning(
            "batches_for_epoch: dropped %d incomplete batches (epoch %d)",
            dropped, epoch)


def adapt_batch_time_ids(batch: Dict[str, np.ndarray], num_time_ids: int,
                         aesthetic_score: float = 6.0
                         ) -> Dict[str, np.ndarray]:
    """Map the cache's canonical 6-wide SDXL micro-conditioning rows
    [orig_h, orig_w, crop_t, crop_l, tgt_h, tgt_w] to what the loaded UNet
    topology consumes.  The only non-identity mapping in the SDXL family is
    the refiner's 5-id row, where a constant aesthetic score replaces the
    target size (``config.model.aesthetic_score``).  One precomputed cache
    serves base and refiner fine-tunes alike."""
    tids = batch.get("time_ids")
    if tids is None or tids.shape[-1] == num_time_ids:
        return batch
    if tids.shape[-1] == 6 and num_time_ids == 5:
        out = dict(batch)
        score = np.full((tids.shape[0], 1), aesthetic_score, tids.dtype)
        out["time_ids"] = np.concatenate([tids[:, :4], score], axis=1)
        return out
    raise ValueError(
        f"cannot adapt time_ids width {tids.shape[-1]} to the UNet's "
        f"num_time_ids={num_time_ids}")


def adapt_time_ids_iter(batch_iter, num_time_ids: int,
                        aesthetic_score: float = 6.0):
    for batch in batch_iter:
        yield adapt_batch_time_ids(batch, num_time_ids, aesthetic_score)


def prefetch_to_device(batch_iter, device="cuda", prefetch: int = 2
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Device-resident batches, copied up to ``prefetch`` steps ahead.

    A background thread assembles each host batch (cache reads and
    ``np.stack`` overlap the step) and, on a card, copies it into pinned
    memory and from there to the device with ``non_blocking=True`` on a
    side stream.  The copy is ordered before the step that reads it: the
    consumer's stream waits on the copy's event, and each tensor is
    marked as used on that stream (``record_stream``), so the allocator
    does not hand its memory to the side stream again while the step
    still reads it.  On the CPU the batch is handed over as tensors.  An
    exception in the worker reaches the consumer; closing the iterator
    stops the worker.
    """
    device = torch.device(device)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(b):
        if copy_stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in b.items()}, None
        with torch.cuda.stream(copy_stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(device, non_blocking=True) for k, v in b.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()
    end = object()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                pass
        return False

    def worker():
        try:
            for batch in batch_iter:
                if not offer(put(batch)):
                    return
            offer(end)
        except BaseException as e:  # propagate into the consumer
            offer(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for v in batch.values():
                    v.record_stream(stream)
            yield batch
    finally:
        stop.set()
