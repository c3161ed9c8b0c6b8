"""Device-transform datamodule base (counterpart of
``viscy_tpu/data/gpu_aug.py``'s ``DeviceTransformDataModule``)."""

from __future__ import annotations

import torch

from viscy_tpu_torch.data.hcs import DataModule
from viscy_tpu_torch.transforms.base import Compose


class DeviceTransformDataModule(DataModule):
    """Datamodules whose batched train/val augmentations run on the device,
    inside the trainer's step, after the batch has moved there."""

    train_device_transforms: Compose | None = None
    val_device_transforms: Compose | None = None

    def device_transform(self, batch: dict, generator: torch.Generator, stage: str = "train") -> dict:
        compose = self.train_device_transforms if stage == "train" else self.val_device_transforms
        if compose is not None:
            batch = compose(batch, generator)
        return batch
