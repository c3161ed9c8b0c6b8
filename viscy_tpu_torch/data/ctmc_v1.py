"""CTMC-v1 autoregression datamodule (counterpart of
``viscy_tpu/data/ctmc_v1.py``; reference ``viscy_data/ctmc_v1.py``):
consecutive-frame pairs from live-cell OME-Zarr time lapses for next-frame
objectives, train and validation from two plates."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from viscy_tpu_torch.data.hcs import DataModule, _HostCompose
from viscy_tpu_torch.data.loader import DataLoader
from viscy_tpu_torch.zarr_io.store import open_ome_zarr

__all__ = ["CTMCv1DataModule", "CTMCv1Dataset"]


class CTMCv1Dataset:
    """``{"source": frame t, "target": frame t + 1}`` of one channel, (1, Z,
    Y, X) float32, for every t of every FOV; the host transforms draw from
    ``default_rng((seed, epoch, idx))``."""

    def __init__(self, positions, channel: str, transform=None, seed: int = 42) -> None:
        self.positions = positions
        self.channel = channel
        self.transform = transform
        self.seed = seed
        self._ch_idx = positions[0].get_channel_index(channel)
        self._index = [(pi, t) for pi, pos in enumerate(positions) for t in range(pos["0"].frames - 1)]

    def __len__(self) -> int:
        return len(self._index)

    def get_item_with_epoch(self, idx: int, epoch: int) -> dict:
        pi, t = self._index[idx]
        pair = self.positions[pi]["0"].oindex[slice(t, t + 2), [self._ch_idx]].astype(np.float32)
        sample = {"source": pair[0], "target": pair[1]}
        if self.transform is not None:
            sample = self.transform(sample, np.random.default_rng((self.seed, epoch, idx)))
        return sample

    def __getitem__(self, idx: int) -> dict:
        return self.get_item_with_epoch(idx, 0)


class CTMCv1DataModule(DataModule):
    """Train over ``train_data_path``'s FOVs, validate over
    ``val_data_path``'s (the CTMC-v1 convention: separate stores);
    ``normalizations`` run on the host. Only the fit and validate stages."""

    def __init__(
        self,
        train_data_path: str | Path,
        val_data_path: str | Path,
        channel: str = "DIC",
        batch_size: int = 16,
        num_workers: int = 4,
        normalizations: list | None = None,
        seed: int = 42,
    ) -> None:
        self.train_data_path = Path(train_data_path)
        self.val_data_path = Path(val_data_path)
        self.channel = channel
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.normalizations = list(normalizations or [])
        self.seed = seed

    def setup(self, stage: str) -> None:
        if stage not in ("fit", "validate"):
            raise NotImplementedError(stage)
        transform = _HostCompose(self.normalizations)
        positions = lambda path: [p for _, p in open_ome_zarr(path).positions()]
        self.train_dataset = CTMCv1Dataset(positions(self.train_data_path), self.channel, transform, self.seed)
        self.val_dataset = CTMCv1Dataset(positions(self.val_data_path), self.channel, transform, self.seed)

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self.train_dataset, batch_size=self.batch_size, shuffle=True,
                          num_workers=self.num_workers, drop_last=True)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.val_dataset, batch_size=self.batch_size, num_workers=self.num_workers)
