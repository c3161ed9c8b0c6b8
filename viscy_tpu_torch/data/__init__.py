"""Data layer: the HCS, triplet, concatenated and combined, CTMC-v1,
classification and cell-division datamodules and their datasets, loader and
host transforms."""

from viscy_tpu_torch.data.cell_classification import ClassificationDataModule, ClassificationDataset
from viscy_tpu_torch.data.cell_division_triplet import CellDivisionTripletDataModule, CellDivisionTripletDataset
from viscy_tpu_torch.data.channel_dropout import ChannelDropout
from viscy_tpu_torch.data.channel_utils import ChannelMetadata, parse_channel_name
from viscy_tpu_torch.data.combined import (
    BatchedConcatDataModule,
    BatchedConcatDataset,
    CachedConcatDataModule,
    CombinedDataModule,
    CombineMode,
    ConcatDataModule,
)
from viscy_tpu_torch.data.ctmc_v1 import CTMCv1DataModule, CTMCv1Dataset
from viscy_tpu_torch.data.hcs import DataModule, HCSDataModule
from viscy_tpu_torch.data.mmap_cache import MmappedDataModule, MmappedDataset
from viscy_tpu_torch.data.select import SelectWell
from viscy_tpu_torch.data.triplet import TripletDataModule, TripletDataset

__all__ = [
    "BatchedConcatDataModule",
    "BatchedConcatDataset",
    "CTMCv1DataModule",
    "CTMCv1Dataset",
    "CachedConcatDataModule",
    "CellDivisionTripletDataModule",
    "CellDivisionTripletDataset",
    "ChannelDropout",
    "ChannelMetadata",
    "ClassificationDataModule",
    "ClassificationDataset",
    "CombineMode",
    "CombinedDataModule",
    "ConcatDataModule",
    "DataModule",
    "HCSDataModule",
    "MmappedDataModule",
    "MmappedDataset",
    "SelectWell",
    "TripletDataModule",
    "TripletDataset",
    "parse_channel_name",
]
