"""Single-cell classification datamodule (counterpart of
``viscy_tpu/data/cell_classification.py``; reference
``viscy_data/cell_classification.py``): patches centered on annotated
cells with integer labels, for supervised cell-state classification.

Annotations are a CSV table (``fov_name``, ``y``, ``x``, the label column,
``t`` optional) read without pandas (``data/_tracks.py``); a ``.parquet``
table is refused by name, since the card's machine has no parquet reader.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from viscy_tpu_torch.data._tracks import read_csv
from viscy_tpu_torch.data.hcs import DataModule, _HostCompose
from viscy_tpu_torch.data.loader import DataLoader
from viscy_tpu_torch.data.utils import read_norm_meta
from viscy_tpu_torch.evaluation.anndata_lite import Frame
from viscy_tpu_torch.zarr_io.store import open_ome_zarr

__all__ = ["ClassificationDataModule", "ClassificationDataset"]


class ClassificationDataset:
    """``{"source": (C, z_window_size, *yx_patch_size) float32, "label":
    int32}`` for every annotated cell whose center lies at least half a
    patch inside the FOV's borders (the others are dropped); the Z window
    is centered in the stack. Host transforms see one ``(1, Z, Y, X)`` key
    per channel (and ``norm_meta`` when the FOV has it) and draw from
    ``default_rng((seed, epoch, idx))``."""

    def __init__(
        self,
        plate,
        annotations: Frame,
        channel_names: Sequence[str],
        z_window_size: int,
        yx_patch_size: tuple[int, int] = (128, 128),
        label_column: str = "label",
        transform=None,
        seed: int = 42,
    ) -> None:
        self.plate = plate
        self.channel_names = list(channel_names)
        self.z_window_size = z_window_size
        self.yx_patch_size = tuple(yx_patch_size)
        self.label_column = label_column
        self.transform = transform
        self.seed = seed
        y_half, x_half = (d // 2 for d in self.yx_patch_size)
        self._positions = {}
        keep = []
        for i in range(len(annotations)):
            img = self._get_position(str(annotations["fov_name"][i]))["0"]
            y, x = annotations["y"][i], annotations["x"][i]
            if y_half <= y < img.height - y_half and x_half <= x < img.width - x_half:
                keep.append(i)
        self.annotations = annotations.take(np.asarray(keep, dtype=np.int64)).reset_index()

    def _get_position(self, fov_name: str):
        if fov_name not in self._positions:
            self._positions[fov_name] = self.plate[fov_name]
        return self._positions[fov_name]

    def __len__(self) -> int:
        return len(self.annotations)

    def get_item_with_epoch(self, idx: int, epoch: int) -> dict:
        ann = self.annotations
        pos = self._get_position(str(ann["fov_name"][idx]))
        img = pos["0"]
        ch_idx = [pos.get_channel_index(c) for c in self.channel_names]
        z_total = img.slices
        z0 = max(0, min(z_total - self.z_window_size, z_total // 2 - self.z_window_size // 2))
        y_half, x_half = (d // 2 for d in self.yx_patch_size)
        y, x = int(ann["y"][idx]), int(ann["x"][idx])
        t = int(ann["t"][idx]) if "t" in ann else 0
        patch = img.oindex[
            t, ch_idx, slice(z0, z0 + self.z_window_size), slice(y - y_half, y + y_half), slice(x - x_half, x + x_half)
        ].astype(np.float32)
        sample = {name: patch[i : i + 1] for i, name in enumerate(self.channel_names)}
        norm = read_norm_meta(pos)
        if norm is not None:
            sample["norm_meta"] = norm
        if self.transform is not None:
            sample = self.transform(sample, np.random.default_rng((self.seed, epoch, idx)))
        return {
            "source": np.concatenate([sample[c] for c in self.channel_names], axis=0),
            "label": np.int32(ann[self.label_column][idx]),
        }

    def __getitem__(self, idx: int) -> dict:
        return self.get_item_with_epoch(idx, 0)


class ClassificationDataModule(DataModule):
    """Supervised cell-state classification over a plate and its
    annotations. Fit splits the annotation rows by
    ``default_rng(seed).permutation``, the first ``int(n * split_ratio)``
    for training; test and predict read every row. ``normalizations`` run
    on the host."""

    def __init__(
        self,
        data_path: str | Path,
        annotations_path: str | Path,
        channel_names: Sequence[str],
        z_window_size: int,
        yx_patch_size: tuple[int, int] = (128, 128),
        label_column: str = "label",
        batch_size: int = 32,
        num_workers: int = 4,
        split_ratio: float = 0.8,
        normalizations: list | None = None,
        seed: int = 42,
    ) -> None:
        self.data_path = Path(data_path)
        self.annotations_path = Path(annotations_path)
        self.channel_names = list(channel_names)
        self.z_window_size = z_window_size
        self.yx_patch_size = tuple(yx_patch_size)
        self.label_column = label_column
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.split_ratio = split_ratio
        self.normalizations = list(normalizations or [])
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def setup(self, stage: str) -> None:
        plate = open_ome_zarr(self.data_path, mode="r")
        if self.annotations_path.suffix == ".parquet":
            raise NotImplementedError(
                f"{self.annotations_path}: parquet annotations are not readable in viscy_tpu_torch (no parquet "
                "reader); write the table as CSV"
            )
        ann = read_csv(self.annotations_path)
        kwargs = dict(plate=plate, channel_names=self.channel_names, z_window_size=self.z_window_size,
                      yx_patch_size=self.yx_patch_size, label_column=self.label_column,
                      transform=_HostCompose(self.normalizations), seed=self.seed)
        if stage in ("fit", "validate"):
            perm = np.random.default_rng(self.seed).permutation(len(ann))
            n_train = int(len(ann) * self.split_ratio)
            self.train_dataset = ClassificationDataset(annotations=ann.take(perm[:n_train]), **kwargs)
            self.val_dataset = ClassificationDataset(annotations=ann.take(perm[n_train:]), **kwargs)
        elif stage in ("test", "predict"):
            self.test_dataset = self.predict_dataset = ClassificationDataset(annotations=ann, **kwargs)

    def train_dataloader(self) -> DataLoader:
        loader = DataLoader(self.train_dataset, batch_size=self.batch_size, shuffle=True,
                            num_workers=self.num_workers, drop_last=True, seed=self.seed)
        loader.set_epoch(self._epoch)
        return loader

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.val_dataset, batch_size=self.batch_size, num_workers=self.num_workers)

    def test_dataloader(self) -> DataLoader:
        return DataLoader(self.test_dataset, batch_size=self.batch_size, num_workers=self.num_workers)

    def predict_dataloader(self) -> DataLoader:
        return self.test_dataloader()
