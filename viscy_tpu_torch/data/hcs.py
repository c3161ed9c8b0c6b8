"""HCSDataModule: the supervised datamodule over an HCS OME-Zarr plate
(counterpart of ``viscy_tpu/data/hcs.py``), and the ``DataModule`` protocol.

As in the JAX package:

- loader threads read and crop on the host (any augmentation that
  subclasses ``HostTransform``); the other augmentations run batched on the
  device, inside the trainer's step, through ``device_transform``;
- normalization runs on the device by default (``NormalizeSampled`` /
  ``MinMaxSampled`` with the batch's per-sample ``norm_meta``);
- the FOV shuffle and train/val split come from a seeded numpy Generator;
- a device affine that scales Z widens the training window in Z
  (``ceil(z_window_size * (1 + max scale - 1))``, even), so the affine
  can zoom out without reading past the stack;
- ``caching`` preloads the selected channels of every FOV into RAM (with
  the weighted crop as the only host transform, the crop is pushed down);
- in a job of several processes the train and validation loaders read
  through the sharded sampler, each rank its own windows; the test and
  predict loaders read every window on every rank.

One difference: the predict stage reads the target channels as the JAX
package does only when the plate has them; a plate without them (the
usual input of ``viscy predict``) is read for its source channels alone,
as the reference VisCy datamodule reads it, where the JAX package raises.
"""

from __future__ import annotations

import logging
import math
import os
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from viscy_tpu_torch.data.host_transforms import HostRandWeightedCropd, HostTransform
from viscy_tpu_torch.data.loader import DataLoader
from viscy_tpu_torch.data.sliding_window import MaskTestDataset, SlidingWindowDataset
from viscy_tpu_torch.transforms.affine import BatchedRandAffined
from viscy_tpu_torch.transforms.base import Compose
from viscy_tpu_torch.transforms.normalize import MinMaxSampled, NormalizeSampled
from viscy_tpu_torch.zarr_io.store import Position, open_ome_zarr

_logger = logging.getLogger("viscy_tpu_torch")


class DataModule:
    """Base datamodule protocol. ``Trainer.predict`` runs
    ``device_transform(batch, None, "predict")`` only on a datamodule that
    sets ``predict_device_transform``."""

    predict_device_transform = False

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


class HCSDataModule(DataModule):
    """Supervised datamodule over a preprocessed HCS OME-Zarr plate.

    The JAX datamodule's keyword arguments; ``mmap_preload``,
    ``scratch_dir``, ``persistent_workers`` and ``pin_memory`` are accepted
    for config compatibility and do nothing (``mmap_preload`` means
    ``caching``), as there. The ``test`` stage reads every FOV of the plate
    in whole windows, one a batch, with the ground-truth masks of
    ``ground_truth_masks`` (``MaskTestDataset``)."""

    def __init__(
        self,
        data_path: str | Path,
        source_channel: str | Sequence[str],
        target_channel: str | Sequence[str],
        z_window_size: int,
        split_ratio: float = 0.8,
        batch_size: int = 16,
        num_workers: int = 8,
        target_2d: bool = False,
        yx_patch_size: tuple[int, int] = (256, 256),
        normalizations: list | None = None,
        augmentations: list | None = None,
        caching: bool = False,
        ground_truth_masks: str | None = None,
        array_key: str = "0",
        min_nonzero_fraction: float = 0.0,
        nonzero_threshold: float = 0.0,
        nonzero_channel: str | None = None,
        max_nonzero_retries: int = 100,
        gpu_augmentations: list | None = None,
        val_augmentations: list | None = None,
        val_gpu_augmentations: list | None = None,
        include_fov_names: Iterable[str] | None = None,
        exclude_fov_names: Iterable[str] | None = None,
        normalize_on_device: bool = True,
        native_transfer: bool = False,
        seed: int = 42,
        prefetch_factor: int = 2,
        mmap_preload: bool = False,
        scratch_dir: str | None = None,
        persistent_workers: bool = False,
        pin_memory: bool = False,
        fg_mask_key: str | None = None,
    ) -> None:
        self.data_path = Path(data_path) if data_path is not None else None
        self.source_channel = [source_channel] if isinstance(source_channel, str) else list(source_channel)
        self.target_channel = [target_channel] if isinstance(target_channel, str) else list(target_channel)
        self.z_window_size = z_window_size
        self.split_ratio = split_ratio
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.target_2d = target_2d
        self.yx_patch_size = tuple(yx_patch_size)
        self.normalizations = list(normalizations or [])
        self.caching = caching or mmap_preload
        self.ground_truth_masks = ground_truth_masks
        self.array_key = array_key
        self.min_nonzero_fraction = min_nonzero_fraction
        self.nonzero_threshold = nonzero_threshold
        self.nonzero_channel = nonzero_channel
        self.max_nonzero_retries = max_nonzero_retries
        self.include_fov_names = include_fov_names
        self.exclude_fov_names = exclude_fov_names
        self.normalize_on_device = normalize_on_device
        # the store's dtype goes to the device (uint16: half the copy);
        # the device transform casts to float32 before normalizing
        self.native_transfer = native_transfer and normalize_on_device
        if native_transfer and not normalize_on_device:
            _logger.warning("native_transfer needs normalize_on_device=True; disabled")
        self.seed = seed
        self.prefetch_factor = prefetch_factor
        self.fg_mask_key = fg_mask_key
        augmentations = list(augmentations or []) + list(gpu_augmentations or [])
        self._host_augmentations = [a for a in augmentations if isinstance(a, HostTransform)]
        self._device_augmentations = [a for a in augmentations if not isinstance(a, HostTransform)]
        self._val_device_augmentations = list(val_augmentations or []) + list(val_gpu_augmentations or [])
        if self.fg_mask_key:
            # spatial device transforms move the mask with source/target
            _patch_spatial_transforms_for_mask(self._device_augmentations)
            _patch_spatial_transforms_for_mask(self._val_device_augmentations)
        self._device_compose = Compose(self._device_augmentations) if self._device_augmentations else None
        self._val_device_compose = (
            Compose(self._val_device_augmentations) if self._val_device_augmentations else None
        )
        self._epoch = 0
        self._train_loader: DataLoader | None = None

    @property
    def train_patches_per_stack(self) -> int:
        for a in self._host_augmentations:
            if isinstance(a, HostRandWeightedCropd):
                return a.num_samples
        return 1

    @property
    def train_z_scale_range(self) -> tuple[float, float]:
        """Z scale range of a device affine (for the widened Z window)."""
        for a in self._device_augmentations:
            if isinstance(a, BatchedRandAffined) and a.scale_range is not None:
                lo, hi = a.scale_range[0]
                return (lo - 1.0, hi - 1.0) if hi >= 1.0 else (0.0, 0.0)
        return (0.0, 0.0)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self._train_loader is not None:
            self._train_loader.set_epoch(epoch)

    # -- setup -----------------------------------------------------------------
    def _filtered_positions(self, plate) -> list[Position]:
        include = set(self.include_fov_names) if self.include_fov_names else None
        exclude = set(self.exclude_fov_names) if self.exclude_fov_names else set()
        out = [
            pos
            for name, pos in plate.positions()
            if (include is None or name in include) and name not in exclude
        ]
        if not out:
            raise ValueError("No FOVs left after include/exclude filtering")
        return out

    def _dataset_settings(self, with_target: bool = True) -> dict:
        channels = {"source": self.source_channel}
        if with_target:
            channels["target"] = self.target_channel
        return dict(
            channels=channels,
            z_window_size=self.z_window_size,
            array_key=self.array_key,
            seed=self.seed,
            keep_dtype=self.native_transfer,
        )

    def _fit_transforms(self):
        norm = [] if self.normalize_on_device else list(self.normalizations)
        train = _HostCompose(norm + self._host_augmentations)
        val = _HostCompose(norm + [a for a in self._host_augmentations if isinstance(a, HostRandWeightedCropd)])
        return train, val

    def setup(self, stage: str) -> None:
        if stage in ("fit", "validate"):
            self._setup_fit()
        elif stage == "predict":
            self._setup_predict()
        elif stage == "test":
            self._setup_test()
        else:
            raise NotImplementedError(f"Unknown stage {stage}")

    def _setup_fit(self) -> None:
        plate = open_ome_zarr(self.data_path, mode="r")
        positions = self._filtered_positions(plate)
        order = np.random.default_rng(self.seed).permutation(len(positions))
        positions = [positions[i] for i in order]
        num_train = int(len(positions) * self.split_ratio)
        if len(positions) >= 2:
            num_train = min(max(num_train, 1), len(positions) - 1)
        elif num_train < 1:
            raise ValueError(
                f"Need at least 2 FOVs for a train/val split, got {len(positions)} after filtering."
            )
        train_transform, val_transform = self._fit_transforms()
        settings = self._dataset_settings()
        settings["fg_mask_key"] = self.fg_mask_key
        train_settings = dict(settings)
        _, z_hi = self.train_z_scale_range
        if z_hi > 0.0:
            expanded = math.ceil(self.z_window_size * (1 + z_hi))
            train_settings["z_window_size"] = expanded - expanded % 2
        train_settings.update(
            min_nonzero_fraction=self.min_nonzero_fraction,
            nonzero_threshold=self.nonzero_threshold,
            nonzero_channel=self.nonzero_channel,
            max_nonzero_retries=self.max_nonzero_retries,
        )
        train_preload = val_preload = pushdown = None
        if self.caching:
            all_data = self._preload_positions(positions)
            train_preload, val_preload = all_data[:num_train], all_data[num_train:]
            # the crop can run on preloaded views when normalization is on
            # the device and the weighted crop is the only host transform
            if (
                self.normalize_on_device
                and len(self._host_augmentations) == 1
                and isinstance(self._host_augmentations[0], HostRandWeightedCropd)
            ):
                pushdown = self._host_augmentations[0]
        self.train_dataset = SlidingWindowDataset(
            positions[:num_train],
            transform=train_transform,
            preloaded_fovs=train_preload,
            pushdown_crop=pushdown,
            crop_threads=self._crop_threads(),
            **train_settings,
        )
        self.val_dataset = SlidingWindowDataset(
            positions[num_train:], transform=val_transform, preloaded_fovs=val_preload, **settings
        )

    def _crop_threads(self) -> int:
        """Threads a call of the pushdown crop (host kernel H1): the loader's
        threads crop at once, so each takes its share of the host's cores
        (``max(1, cores // num_workers)``; the whole host without workers)."""
        cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1
        return max(1, cores // self.num_workers) if self.num_workers > 0 else 0

    def _preload_positions(self, positions: list[Position]) -> list[np.ndarray]:
        """(T, C, Z, Y, X) of the selected channels of each FOV, in RAM."""
        ch_idx = [positions[0].get_channel_index(c) for c in self.source_channel + self.target_channel]
        out = []
        for pos in positions:
            raw = pos[self.array_key].oindex[:, ch_idx]
            out.append(raw if self.native_transfer else raw.astype(np.float32))
        return out

    def _setup_test(self) -> None:
        """Every FOV of the plate, whole windows, the host normalizations;
        ground-truth masks beside them when ``ground_truth_masks`` is set."""
        positions = [p for _, p in open_ome_zarr(self.data_path, mode="r").positions()]
        transform = _HostCompose(self.normalizations)
        if self.ground_truth_masks:
            self.test_dataset = MaskTestDataset(positions, transform=transform,
                                                ground_truth_masks=self.ground_truth_masks,
                                                **self._dataset_settings())
        else:
            self.test_dataset = SlidingWindowDataset(positions, transform=transform, **self._dataset_settings())

    def _setup_predict(self) -> None:
        store = open_ome_zarr(self.data_path, mode="r")
        positions = [store] if isinstance(store, Position) else self._filtered_positions(store)
        with_target = set(self.target_channel) <= set(positions[0].channel_names)
        self.predict_dataset = SlidingWindowDataset(
            positions,
            transform=_HostCompose(self.normalizations),
            **self._dataset_settings(with_target=with_target),
        )

    # -- loaders -------------------------------------------------------------------
    def train_dataloader(self) -> DataLoader:
        self._train_loader = DataLoader(
            self.train_dataset,
            batch_size=max(1, self.batch_size // self.train_patches_per_stack),
            shuffle=True,
            num_workers=self.num_workers,
            drop_last=True,
            prefetch_factor=self.prefetch_factor,
            seed=self.seed,
        )
        self._train_loader.set_epoch(self._epoch)
        return self._train_loader

    def val_dataloader(self) -> DataLoader:
        return DataLoader(
            self.val_dataset,
            batch_size=max(1, self.batch_size // self.train_patches_per_stack),
            shuffle=False,
            num_workers=self.num_workers,
            seed=self.seed,
        )

    def test_dataloader(self) -> DataLoader:
        return DataLoader(self.test_dataset, batch_size=1, num_workers=self.num_workers, distributed=False)

    def predict_dataloader(self) -> DataLoader:
        return DataLoader(self.predict_dataset, batch_size=self.batch_size, num_workers=self.num_workers,
                          distributed=False)

    # -- the device transform --------------------------------------------------------
    def _apply_device_normalizations(self, batch: dict) -> dict:
        """``NormalizeSampled`` / ``MinMaxSampled`` on the stacked source and
        target tensors, with each sample's statistics from ``norm_meta``."""
        norm_meta = batch.get("norm_meta")
        if norm_meta is None or not self.normalizations:
            return batch
        batch = dict(batch)
        groups = {"source": self.source_channel, "target": self.target_channel}
        for t in self.normalizations:
            if not isinstance(t, (NormalizeSampled, MinMaxSampled)):
                continue
            for tensor_key, channels in groups.items():
                if tensor_key not in batch:
                    continue
                x = batch[tensor_key]
                cols = []
                for ci, ch in enumerate(channels):
                    col = x[:, ci : ci + 1]
                    if ch in t.keys:
                        level = norm_meta[ch][t.level]
                        stat = lambda k: torch.as_tensor(level[k], device=x.device).reshape(-1, 1, 1, 1, 1)
                        if isinstance(t, NormalizeSampled):
                            col = (col - stat(t.subtrahend)) / (stat(t.divisor) + 1e-8)
                        else:
                            lo, hi = stat(t._low_key), stat(t._high_key)
                            col = torch.minimum(torch.maximum(col, lo), hi)
                            col = 2.0 * (col - lo) / (hi - lo + 1e-8) - 1.0
                    cols.append(col)
                batch[tensor_key] = torch.cat(cols, dim=1)
        return batch

    def device_transform(
        self,
        batch: dict,
        generator: torch.Generator | None = None,
        stage: str = "train",
        draws: Sequence[dict] | None = None,
    ) -> dict:
        """Cast, normalize, augment (``generator``, or the given ``draws`` of
        the random members) and check the shape of a device batch."""
        batch = dict(batch)
        for k in ("source", "target", "fg_mask"):
            if k in batch and not (batch[k].dtype.is_floating_point or batch[k].dtype == torch.bool):
                batch[k] = batch[k].to(torch.float32)
        if self.normalize_on_device and stage in ("train", "val"):
            batch = self._apply_device_normalizations(batch)
        if stage == "train" and self._device_compose is not None:
            batch = self._device_compose(batch, generator, draws)
        elif stage == "val" and self._val_device_compose is not None:
            batch = self._val_device_compose(batch, generator, draws)
        has_shape_aug = any(getattr(t, "changes_shape", False) for t in self._device_augmentations)
        if stage == "train" and not has_shape_aug and "source" in batch:
            # no device crop: a window that is not the configured patch
            # fails here, with a message that says what to configure
            expected = (self.z_window_size, *self.yx_patch_size)
            actual = tuple(batch["source"].shape[2:])
            if actual != expected:
                raise ValueError(
                    f"Source spatial shape {actual} does not match expected "
                    f"{expected} (z_window_size={self.z_window_size}, "
                    f"yx_patch_size={list(self.yx_patch_size)}). "
                    "Configure augmentations with a spatial crop (e.g. "
                    "BatchedCenterSpatialCropd / BatchedRandSpatialCropd) "
                    "to match yx_patch_size."
                )
        if self.target_2d and "target" in batch:
            z_index = self.z_window_size // 2
            batch["target"] = batch["target"][:, :, z_index : z_index + 1]
            if "fg_mask" in batch:
                batch["fg_mask"] = batch["fg_mask"][:, :, z_index : z_index + 1]
        return batch


def _patch_spatial_transforms_for_mask(transforms: list, mask_key: str = "fg_mask") -> None:
    """Add ``fg_mask`` to the keys of spatial device transforms that touch
    source or target (intensity transforms never take it); missing keys are
    allowed, so batches without a mask pass."""
    for t in transforms:
        keys = getattr(t, "keys", ())
        if getattr(t, "is_spatial", False) and ("target" in keys or "source" in keys) and mask_key not in keys:
            t.keys = tuple(keys) + (mask_key,)
            t.allow_missing_keys = True


class _HostCompose:
    """Host transforms in order, threading a numpy Generator; a weighted
    crop's list of samples is carried through the rest."""

    def __init__(self, transforms: list) -> None:
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, data: dict, rng: np.random.Generator | None = None):
        items = [data]
        for t in self.transforms:
            next_items = []
            for item in items:
                takes_rng = isinstance(t, HostTransform) or getattr(t, "accepts_rng", False)
                out = t(item, rng) if takes_rng else t(item)
                next_items.extend(out if isinstance(out, list) else [out])
            items = next_items
        return items if len(items) > 1 else items[0]
