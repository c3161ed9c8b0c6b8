"""Threaded prefetching DataLoader of the host input pipeline (counterpart
of ``viscy_tpu/data/loader.py``).

A thread pool loads the items of a few batches ahead (chunk reads and
decompression release the GIL) and collates them in order into numpy
batches; a bounded queue hands them to the consumer. Shuffling is a numpy
permutation seeded with ``seed + epoch``. In a job of several processes a
loader with ``distributed="auto"`` reads through a
:class:`~viscy_tpu_torch.data.distributed.ShardedDistributedSampler`, so
each rank loads its own slice of the indices.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from viscy_tpu_torch.data.utils import collate_samples
from viscy_tpu_torch.parallel.distributed import process_count


class DataLoader:
    """Iterable over collated numpy batches with background prefetch.

    With ``distributed="auto"``, a job of more than one process reads
    through a ``ShardedDistributedSampler`` (``shuffle``, ``seed`` and
    ``drop_last`` passed on), as the JAX loader does; loaders whose
    consumer writes on one host (predict, test) pass ``False``."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = False,
        prefetch_factor: int = 2,
        seed: int = 42,
        distributed: bool | str = "auto",
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = None
        if distributed and process_count() > 1:
            from viscy_tpu_torch.data.distributed import ShardedDistributedSampler

            self.sampler = ShardedDistributedSampler(dataset, shuffle=shuffle, seed=seed, drop_last=drop_last)
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.prefetch_factor = prefetch_factor
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _batches(self) -> list[list[int]]:
        if self.sampler is not None:
            indices = list(self.sampler)
        else:
            indices = list(range(len(self.dataset)))
            if self.shuffle:
                np.random.default_rng(self.seed + self.epoch).shuffle(indices)
        batches = [indices[i : i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __len__(self) -> int:
        return len(self._batches())

    def __iter__(self) -> Iterator[dict]:
        batches = self._batches()
        if not batches:
            return
        if self.num_workers == 0:
            for b in batches:
                yield collate_samples([self._load_item(i) for i in b])
            return
        out_q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch_factor))
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    it = iter(batches)
                    pending = []
                    for _ in range(max(2, self.prefetch_factor + 1)):
                        b = next(it, None)
                        if b is None:
                            break
                        pending.append([pool.submit(self._load_item, i) for i in b])
                    while pending:
                        futs = pending.pop(0)
                        if stop.is_set():
                            for f in (f for fs in pending for f in fs):
                                f.cancel()
                            return
                        if not put(collate_samples([f.result() for f in futs])):
                            return
                        nxt = next(it, None)
                        if nxt is not None:
                            pending.append([pool.submit(self._load_item, i) for i in nxt])
            except Exception as e:  # surfaces in the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True, name="viscy-loader")
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def _load_item(self, idx: int):
        if hasattr(self.dataset, "get_item_with_epoch"):
            return self.dataset.get_item_with_epoch(idx, self.epoch)
        return self.dataset[idx]
