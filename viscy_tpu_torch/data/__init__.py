"""Data layer: the HCS datamodule and its datasets, loader and host transforms."""

from viscy_tpu_torch.data.hcs import DataModule, HCSDataModule

__all__ = ["DataModule", "HCSDataModule"]
