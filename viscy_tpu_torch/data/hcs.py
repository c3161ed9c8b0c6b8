"""Datamodule protocol (counterpart of ``viscy_tpu/data/hcs.py``'s
``DataModule``). The HCS OME-Zarr datamodule itself is not ported."""

from __future__ import annotations

import torch


class DataModule:
    """Base datamodule protocol."""

    def prepare_data(self) -> None: ...

    def setup(self, stage: str) -> None: ...

    def train_dataloader(self):
        return None

    def val_dataloader(self):
        return None

    def test_dataloader(self):
        return None

    def predict_dataloader(self):
        return None

    def device_transform(self, batch: dict, generator: torch.Generator, stage: str) -> dict:
        return batch
