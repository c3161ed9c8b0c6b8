"""Data layer: the HCS and triplet datamodules and their datasets, loader and host transforms."""

from viscy_tpu_torch.data.hcs import DataModule, HCSDataModule
from viscy_tpu_torch.data.mmap_cache import MmappedDataModule, MmappedDataset
from viscy_tpu_torch.data.select import SelectWell
from viscy_tpu_torch.data.triplet import TripletDataModule, TripletDataset

__all__ = ["DataModule", "HCSDataModule", "MmappedDataModule", "MmappedDataset", "SelectWell", "TripletDataModule", "TripletDataset"]
