"""Combined and concatenated datamodules (counterpart of
``viscy_tpu/data/combined.py``; reference ``viscy_data/combined.py``).

- ``CombinedDataModule``: child datamodules whose loaders are iterated
  together (``min_size``, ``max_size_cycle`` or ``sequential``).
- ``ConcatDataModule``: the children's datasets concatenated into one
  pool, shuffled together.
- ``BatchedConcatDataModule``: the same with ``batch_size`` counting
  indices (not divided by the patches a stack yields).

The device transform of each is the first child's.
"""

from __future__ import annotations

import enum
from typing import Literal, Sequence

import numpy as np
import torch

from viscy_tpu_torch.data.hcs import DataModule
from viscy_tpu_torch.data.loader import DataLoader
from viscy_tpu_torch.data.utils import collate_samples

__all__ = [
    "BatchedConcatDataModule",
    "BatchedConcatDataset",
    "CachedConcatDataModule",
    "CombineMode",
    "CombinedDataModule",
    "ConcatDataModule",
]


class CombineMode(enum.Enum):
    """How the loaders of several datamodules are combined."""

    MIN_SIZE = "min_size"
    MAX_SIZE_CYCLE = "max_size_cycle"
    MAX_SIZE = "max_size"
    SEQUENTIAL = "sequential"


class _ConcatDataset:
    """Map-style datasets end to end."""

    def __init__(self, datasets: Sequence) -> None:
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.cum[-1])

    def _locate(self, idx: int) -> tuple[int, int]:
        d = int(np.searchsorted(self.cum, idx, side="right"))
        return d, idx - (0 if d == 0 else int(self.cum[d - 1]))

    def __getitem__(self, idx: int):
        d, local = self._locate(idx)
        return self.datasets[d][local]

    def get_item_with_epoch(self, idx: int, epoch: int):
        d, local = self._locate(idx)
        ds = self.datasets[d]
        if hasattr(ds, "get_item_with_epoch"):
            return ds.get_item_with_epoch(local, epoch)
        return ds[local]


class BatchedConcatDataset(_ConcatDataset):
    """Concatenated datasets read in batches: ``__getitems__`` groups global
    indices by child, in first-seen order, and returns one micro-batch per
    child (the child's own ``__getitems__`` where it has one, else its
    samples collated)."""

    def __getitem__(self, idx):
        raise NotImplementedError("use __getitems__ for batched access")

    def __getitems__(self, indices: Sequence[int]) -> list[dict]:
        by_dataset: dict[int, list[int]] = {}
        for idx in indices:
            if idx < 0:
                idx += len(self)
            d, local = self._locate(idx)
            by_dataset.setdefault(d, []).append(local)
        out = []
        for d, locals_ in by_dataset.items():
            ds = self.datasets[d]
            if hasattr(ds, "__getitems__"):
                batch = ds.__getitems__(locals_)
                out.extend(batch if isinstance(batch, list) else [batch])
            else:
                out.append(collate_samples([ds[i] for i in locals_]))
        return out


class CombinedDataModule(DataModule):
    """Child datamodules whose loaders are iterated together, in
    ``train_mode`` / ``val_mode`` / ``test_mode`` / ``predict_mode``."""

    def __init__(
        self,
        data_modules: Sequence[DataModule],
        train_mode: Literal["min_size", "max_size_cycle", "sequential"] = "max_size_cycle",
        val_mode: str = "sequential",
        test_mode: str = "sequential",
        predict_mode: str = "sequential",
    ) -> None:
        self.data_modules = list(data_modules)
        self.train_mode = train_mode
        self.val_mode = val_mode
        self.test_mode = test_mode
        self.predict_mode = predict_mode

    def prepare_data(self) -> None:
        for dm in self.data_modules:
            dm.prepare_data()

    def setup(self, stage: str) -> None:
        for dm in self.data_modules:
            dm.setup(stage)

    def set_epoch(self, epoch: int) -> None:
        for dm in self.data_modules:
            if hasattr(dm, "set_epoch"):
                dm.set_epoch(epoch)

    def _combined(self, loaders: list, mode: str):
        loaders = [ld for ld in loaders if ld is not None]
        return _CombinedLoader(loaders, mode) if loaders else None

    def train_dataloader(self):
        return self._combined([dm.train_dataloader() for dm in self.data_modules], self.train_mode)

    def val_dataloader(self):
        return self._combined([dm.val_dataloader() for dm in self.data_modules], self.val_mode)

    def test_dataloader(self):
        return self._combined([dm.test_dataloader() for dm in self.data_modules], self.test_mode)

    def predict_dataloader(self):
        return self._combined([dm.predict_dataloader() for dm in self.data_modules], self.predict_mode)

    def device_transform(self, batch: dict, generator: torch.Generator | None = None, stage: str = "train",
                         **kwargs) -> dict:
        return self.data_modules[0].device_transform(batch, generator, stage, **kwargs)


class _CombinedLoader:
    """``min_size`` (one batch of each loader in turn until one runs out),
    ``max_size_cycle`` (as many rounds as the longest loader, shorter ones
    restarting) or ``sequential`` (each loader to its end, in order)."""

    def __init__(self, loaders: list, mode: str) -> None:
        self.loaders = loaders
        self.mode = mode

    def set_epoch(self, epoch: int) -> None:
        for ld in self.loaders:
            if hasattr(ld, "set_epoch"):
                ld.set_epoch(epoch)

    def __len__(self) -> int:
        lengths = [len(ld) for ld in self.loaders]
        if self.mode == "min_size":
            return min(lengths)
        if self.mode == "max_size_cycle":
            return max(lengths)
        return sum(lengths)

    def __iter__(self):
        if self.mode == "sequential":
            for ld in self.loaders:
                yield from ld
            return
        iters = [iter(ld) for ld in self.loaders]
        if self.mode == "min_size":
            while True:
                try:
                    batches = [next(it) for it in iters]
                except StopIteration:
                    return
                yield from batches
        elif self.mode == "max_size_cycle":
            for _ in range(max(len(ld) for ld in self.loaders)):
                for i, it in enumerate(iters):
                    try:
                        batch = next(it)
                    except StopIteration:
                        iters[i] = iter(self.loaders[i])
                        batch = next(iters[i])
                    yield batch
        else:
            raise ValueError(f"Unknown mode {self.mode}")


class ConcatDataModule(DataModule):
    """The children's train and validation datasets concatenated and
    shuffled together. ``batch_size`` and ``num_workers`` default to the
    first child's (16 and 4 without them); every child takes this
    ``num_workers``. The children must yield the same number of patches per
    stack; a batch holds ``batch_size // patches per stack`` stacks."""

    def __init__(self, data_modules: Sequence[DataModule], batch_size: int | None = None,
                 num_workers: int | None = None) -> None:
        self.data_modules = list(data_modules)
        self.num_workers = num_workers or getattr(data_modules[0], "num_workers", 4)
        self.batch_size = batch_size or getattr(data_modules[0], "batch_size", 16)
        for dm in data_modules:
            if getattr(dm, "num_workers", self.num_workers) != self.num_workers:
                dm.num_workers = self.num_workers
        self._epoch = 0

    def prepare_data(self) -> None:
        for dm in self.data_modules:
            dm.prepare_data()

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def setup(self, stage: str) -> None:
        self.train_patches_per_stack = None
        for dm in self.data_modules:
            dm.setup(stage)
            pps = getattr(dm, "train_patches_per_stack", 1)
            if self.train_patches_per_stack is None:
                self.train_patches_per_stack = pps
            elif self.train_patches_per_stack != pps:
                raise ValueError("Inconsistent patches per stack across datamodules")
        if stage in ("fit", "validate"):
            self.train_dataset = _ConcatDataset([dm.train_dataset for dm in self.data_modules])
            self.val_dataset = _ConcatDataset([dm.val_dataset for dm in self.data_modules])

    def _stacks_per_batch(self) -> int:
        return max(1, self.batch_size // (self.train_patches_per_stack or 1))

    def train_dataloader(self) -> DataLoader:
        loader = DataLoader(self.train_dataset, batch_size=self._stacks_per_batch(), shuffle=True,
                            num_workers=self.num_workers, drop_last=True)
        loader.set_epoch(self._epoch)
        return loader

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.val_dataset, batch_size=self._stacks_per_batch(), shuffle=False,
                          num_workers=self.num_workers)

    def device_transform(self, batch: dict, generator: torch.Generator | None = None, stage: str = "train",
                         **kwargs) -> dict:
        return self.data_modules[0].device_transform(batch, generator, stage, **kwargs)


class BatchedConcatDataModule(ConcatDataModule):
    """Joint-mode concat: ``batch_size`` counts indices (not divided by the
    patches per stack); the first child's device transform applies to the
    merged batch."""

    def _stacks_per_batch(self) -> int:
        return self.batch_size


class CachedConcatDataModule(ConcatDataModule):
    """Concat of RAM-cached children (children built with ``caching=True``)."""
