"""Host -> device input pipeline: per-bucket batching with a prefetched,
ordered copy to the card.

Port of ``sdxl_training_improvements_tpu/data/pipeline.py``.  Batches are
assembled on the host (numpy) in the JAX package's order, then copied to
the device ahead of the consumer, so the copy overlaps the previous train
step (JAX: ``jax.device_put`` with the batch sharding).

Several ranks (``parallel/mesh.py``): ``check_shard_integrity`` exchanges
each rank's batch count and missing cache entries over the host group and
raises on every rank on a mismatch, and ``prefetch_to_device`` yields the
global batch on every rank, from which the train step takes the rank's
rows (``training/trainer.py`` ``shard_batch``): under a shared cache every
rank iterates the same global sequence; under a partitioned one
(``local_rows=True``) each rank reads its own rows, global rows
``[r * B/W, (r + 1) * B/W)`` as JAX's ``make_array_from_process_local_
data`` places them, and an all-gather over the ranks joins them.
"""
from __future__ import annotations

import logging
import queue as queue_mod
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from sdxl_training_improvements_tpu_torch.parallel import mesh as M


def _host_allgather(values) -> np.ndarray:
    """[ranks, len(values)] of every rank's integers, over the host group."""
    local = torch.tensor(values, dtype=torch.int64)
    out = [torch.zeros_like(local) for _ in range(M.process_count())]
    dist.all_gather(out, local, group=M.host_group())
    return torch.stack(out).numpy()


def check_shard_integrity(dataset, batch_size: int, num_shards: int = 1,
                          shard: int = 0, seed: int = 0) -> int:
    """The per-epoch batch count; over several ranks an input-integrity
    gate (JAX ``pipeline.py:23-60``): each rank counts its batches and its
    bucketed images missing from the cache, the ranks exchange them, and
    a missing entry anywhere or unequal counts raise on every rank
    (uneven batch counts would hang a collective instead).  In one
    process an entry missing from the cache only drops its batch, which
    ``batches_for_epoch`` logs."""
    local_batches = len(dataset.make_sampler(batch_size, seed=seed,
                                             num_shards=num_shards,
                                             shard=shard))
    if M.process_count() <= 1:
        return local_batches
    missing = 0
    if dataset.cache is not None:
        assigned = (i for idxs in dataset.bucket_indices.values()
                    for i in idxs)
        missing = sum(
            1 for i in assigned
            if not dataset.cache.is_cached(dataset.image_paths[i]))
    counts = _host_allgather([local_batches, missing])
    if counts[:, 1].sum() > 0:
        raise RuntimeError(
            f"multi-host input integrity: {int(counts[:, 1].sum())} images "
            f"missing from the latent cache across hosts "
            f"(per-host: {counts[:, 1].tolist()}). Run precompute to "
            "completion (or share the cache) before multi-host training — "
            "on-the-fly drops would desynchronize collectives and hang.")
    if (counts[:, 0] != counts[0, 0]).any():
        raise RuntimeError(
            f"multi-host input integrity: unequal per-host batch counts "
            f"{counts[:, 0].tolist()} — shards would diverge in step count "
            "and hang in the gradient all-reduce. Check that every host "
            "sees the same dataset and equal-count sharding.")
    return int(counts[0, 0])


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


def _join_rows(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global batch of every rank's rows, in rank order."""
    out = {}
    for k, v in batch.items():
        v = v.contiguous()
        full = torch.empty((v.shape[0] * M.process_count(),) + v.shape[1:],
                           dtype=v.dtype, device=v.device)
        dist.all_gather_into_tensor(full, v)
        out[k] = full
    return out


def prefetch_to_device(batch_iter, device="cuda", prefetch: int = 2,
                       local_rows: bool = False
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
    stops the worker.  ``local_rows`` over several ranks: each rank's
    batch is its own rows, joined into the global batch (module
    docstring).
    """
    join = local_rows and M.process_count() > 1
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
            yield _join_rows(batch) if join else batch
    finally:
        stop.set()
