"""Cell-division triplets from ``.npy`` track files (counterpart of
``viscy_tpu/data/cell_division_triplet.py``; reference
``viscy_data/cell_division_triplet.py``).

Each ``.npy`` file holds one division track as a (T, C, Z, Y, X) array,
memory-mapped; anchor and positive are frames ``time_interval`` apart on
one track, the negative a random frame of another track.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from viscy_tpu_torch.data.hcs import DataModule
from viscy_tpu_torch.data.loader import DataLoader

__all__ = ["CellDivisionTripletDataModule", "CellDivisionTripletDataset"]


class CellDivisionTripletDataset:
    """Triplets over per-track volumes. With ``fit`` every (track, t) with a
    frame ``t + time_interval`` is an anchor; the negative's track (not the
    anchor's, when there are several) and then its frame are drawn from
    one ``default_rng(seed)`` per dataset, item by item, in the order items
    are read. Without ``fit`` every frame is an anchor with
    ``index = {"track": path, "t": t}``."""

    def __init__(self, track_files: Sequence[Path], time_interval: int = 1, fit: bool = True,
                 seed: int = 42) -> None:
        self.tracks = [np.load(f, mmap_mode="r") for f in track_files]
        self.track_files = list(track_files)
        self.time_interval = time_interval
        self.fit = fit
        self.rng = np.random.default_rng(seed)
        self._index = [(ti, t) for ti, arr in enumerate(self.tracks)
                       for t in range(arr.shape[0] - (time_interval if fit else 0))]

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> dict:
        ti, t = self._index[idx]
        arr = self.tracks[ti]
        sample = {"anchor": np.asarray(arr[t], np.float32)}
        if self.fit:
            sample["positive"] = np.asarray(arr[t + self.time_interval], np.float32)
            other = int(self.rng.integers(0, len(self.tracks)))
            while other == ti and len(self.tracks) > 1:
                other = int(self.rng.integers(0, len(self.tracks)))
            neg_arr = self.tracks[other]
            sample["negative"] = np.asarray(neg_arr[int(self.rng.integers(0, neg_arr.shape[0]))], np.float32)
        else:
            sample["index"] = {"track": str(self.track_files[ti]), "t": t}
        return sample


class CellDivisionTripletDataModule(DataModule):
    """Datamodule over a directory of per-track ``.npy`` files: the sorted
    files permuted by ``default_rng(seed)``, the first
    ``max(1, int(n * split_ratio))`` for training and the rest (or the
    first file, when none is left) for validation; predict reads every
    file. The draws of the negatives depend on the order items are read, so
    they are reproducible with ``num_workers=0``."""

    def __init__(self, data_path: str | Path, batch_size: int = 16, num_workers: int = 2, split_ratio: float = 0.8,
                 time_interval: int = 1, seed: int = 42) -> None:
        self.data_path = Path(data_path)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.split_ratio = split_ratio
        self.time_interval = time_interval
        self.seed = seed

    def setup(self, stage: str) -> None:
        files = sorted(self.data_path.glob("*.npy"))
        if not files:
            raise FileNotFoundError(f"No .npy tracks under {self.data_path}")
        order = np.random.default_rng(self.seed).permutation(len(files))
        files = [files[i] for i in order]
        n_train = max(1, int(len(files) * self.split_ratio))
        if stage in ("fit", "validate"):
            self.train_dataset = CellDivisionTripletDataset(files[:n_train], self.time_interval, fit=True,
                                                            seed=self.seed)
            self.val_dataset = CellDivisionTripletDataset(files[n_train:] or files[:1], self.time_interval,
                                                          fit=True, seed=self.seed)
        else:
            self.predict_dataset = CellDivisionTripletDataset(files, self.time_interval, fit=False, seed=self.seed)

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self.train_dataset, batch_size=self.batch_size, shuffle=True,
                          num_workers=self.num_workers, drop_last=True)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.val_dataset, batch_size=self.batch_size, num_workers=self.num_workers)

    def predict_dataloader(self) -> DataLoader:
        return DataLoader(self.predict_dataset, batch_size=self.batch_size, num_workers=self.num_workers)
