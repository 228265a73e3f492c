"""Bucket-homogeneous batch sampling.

Counterpart of the reference ``BucketBatchSampler``
(``src/data/preprocessing/samplers.py:8-61``): pre-chunk each bucket's
indices into fixed-size batches (drop_last), then shuffle the batch order —
guaranteeing every batch has a single latent shape.  A copy of the JAX
package's ``data/samplers.py``: the same seed gives the same batches.

Adds what the reference lacks for real DP training: epoch-seeded determinism
and per-process sharding for multi-host input pipelines.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


class BucketBatchSampler:
    """Yields lists of dataset indices, one bucket per batch."""

    def __init__(self, bucket_indices: Dict[Tuple[int, int], Sequence[int]],
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, num_shards: int = 1, shard: int = 0):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if not (0 <= shard < num_shards):
            raise ValueError(f"shard {shard} out of range for {num_shards}")
        self.bucket_indices = {k: list(v) for k, v in bucket_indices.items()}
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard = shard
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches(self) -> List[Tuple[Tuple[int, int], List[int]]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        batches = []
        for bucket, indices in sorted(self.bucket_indices.items()):
            idx = np.asarray(indices)
            if self.shuffle:
                rng.shuffle(idx)
            n_full = len(idx) // self.batch_size
            for i in range(n_full):
                batches.append((bucket,
                                idx[i * self.batch_size:(i + 1) * self.batch_size]
                                .tolist()))
            if not self.drop_last and len(idx) % self.batch_size:
                batches.append((bucket, idx[n_full * self.batch_size:].tolist()))
        if self.shuffle:
            rng.shuffle(batches)
        # shard round-robin over a num_shards-multiple so every process gets
        # the SAME batch count — unequal counts would desynchronize the
        # cross-host collectives inside the jitted step
        if self.num_shards > 1:
            usable = len(batches) - (len(batches) % self.num_shards)
            batches = batches[:usable]
        return batches[self.shard::self.num_shards]

    def __iter__(self) -> Iterator[List[int]]:
        for _, batch in self._batches():
            yield batch

    def iter_with_buckets(self) -> Iterator[Tuple[Tuple[int, int], List[int]]]:
        yield from self._batches()

    def __len__(self) -> int:
        return len(self._batches())
