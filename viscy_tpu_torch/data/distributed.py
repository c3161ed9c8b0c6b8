"""Sharded sampler of the multi-process input pipeline (counterpart of
``viscy_tpu/data/distributed.py``; reference ``viscy_data/distributed.py:16``).

Each process draws a shard-local permutation, an interleaved reshape of the
global index space, so every rank reads its own slice of the windows. The
index streams equal the JAX sampler's element for element.
"""

from __future__ import annotations

import numpy as np

from viscy_tpu_torch.parallel.distributed import process_count, process_index


class ShardedDistributedSampler:
    """Per-rank shard-local permutation sampler. Without ``drop_last`` the
    index space is padded by wrapping to a multiple of ``num_replicas``, so
    every rank draws the same number of samples."""

    def __init__(
        self,
        dataset_len_or_dataset,
        num_replicas: int | None = None,
        rank: int | None = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        if hasattr(dataset_len_or_dataset, "__len__"):
            self.dataset_len = len(dataset_len_or_dataset)
        else:
            self.dataset_len = int(dataset_len_or_dataset)
        self.num_replicas = num_replicas if num_replicas is not None else process_count()
        self.rank = rank if rank is not None else process_index()
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if self.drop_last:
            self.num_samples = self.dataset_len // self.num_replicas
        else:
            self.num_samples = -(-self.dataset_len // self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _sharded_randperm(self, rng: np.random.Generator) -> np.ndarray:
        """Global indices as a (num_samples, num_replicas) grid, each column
        shuffled on its own in column order; this rank's column."""
        grid = (np.arange(self.total_size) % self.dataset_len).reshape(self.num_samples, self.num_replicas)
        for c in range(self.num_replicas):
            rng.shuffle(grid[:, c])
        return grid[:, self.rank]

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle:
            shard = self._sharded_randperm(rng)
        else:
            shard = np.arange(self.total_size)[self.rank :: self.num_replicas] % self.dataset_len
        return iter(shard.tolist())

    def __len__(self) -> int:
        return self.num_samples
