"""Segmentation evaluation dataset and datamodule (counterpart of
``viscy_tpu/data/segmentation.py``): prediction and target plates read
slice by slice for the test stage."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from viscy_tpu_torch.data.hcs import DataModule
from viscy_tpu_torch.data.loader import DataLoader
from viscy_tpu_torch.zarr_io.store import open_ome_zarr


class SegmentationDataset:
    """(prediction, target) 2-D label slices of the positions both plates
    hold, int16, indexed by (position, t, z)."""

    def __init__(self, pred_plate, target_plate, pred_channel: str, target_channel: str, img_name: str = "0") -> None:
        target_by_name = dict(target_plate.positions())
        self.pairs = [(pred_pos, target_by_name[name]) for name, pred_pos in pred_plate.positions()
                      if name in target_by_name]
        self.pred_idx = self.pairs[0][0].get_channel_index(pred_channel)
        self.target_idx = self.pairs[0][1].get_channel_index(target_channel)
        self.img_name = img_name
        self._index = []
        for i, (pred_pos, _) in enumerate(self.pairs):
            arr = pred_pos[img_name]
            self._index.extend((i, t, z) for t in range(arr.frames) for z in range(arr.slices))

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> dict:
        i, t, z = self._index[idx]
        pred_pos, target_pos = self.pairs[i]
        pred = pred_pos[self.img_name][t, self.pred_idx, z].astype(np.int16)
        target = target_pos[self.img_name][t, self.target_idx, z].astype(np.int16)
        return {"pred": pred, "target": target, "position_idx": i, "time_idx": t, "z_idx": z}


class SegmentationDataModule(DataModule):
    """Test-stage datamodule over a prediction and a target plate (batch size
    1 only)."""

    def __init__(self, pred_dataset: str | Path, target_dataset: str | Path, pred_channel: str, target_channel: str,
                 batch_size: int = 1, num_workers: int = 2) -> None:
        if batch_size != 1:
            raise ValueError("Segmentation evaluation requires batch_size=1")
        self.pred_dataset = Path(pred_dataset)
        self.target_dataset = Path(target_dataset)
        self.pred_channel = pred_channel
        self.target_channel = target_channel
        self.batch_size = batch_size
        self.num_workers = num_workers

    def setup(self, stage: str) -> None:
        if stage != "test":
            raise NotImplementedError("SegmentationDataModule only supports testing")
        self.test_dataset = SegmentationDataset(open_ome_zarr(self.pred_dataset), open_ome_zarr(self.target_dataset),
                                                self.pred_channel, self.target_channel)

    def test_dataloader(self) -> DataLoader:
        return DataLoader(self.test_dataset, batch_size=1, num_workers=self.num_workers)
