"""Memory-mapped dataset cache (counterpart of ``viscy_tpu/data/mmap_cache.py``).

The selected channels of every FOV are staged once, as float32, to one
numpy memmap under ``scratch_dir`` (in a ``SLURM_JOB_ID`` subdirectory
when that is set), in a directory named by a fingerprint of the plate's
path, the channels and the FOVs. A ``.done`` marker is written last: a
complete cache is reused, a partial one (no marker, or another size) is
rebuilt. The fit then reads windows from the memmap views instead of the
store.

One difference: ``MmappedDataModule`` refuses ``exclude_fov_names``. The
JAX module stages the FOVs filtered by ``include_fov_names`` alone but
pairs the staged volumes by index with the FOVs left after the exclusions
too, so with an exclusion every FOV after the excluded one would train on
its neighbour's volume.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

from viscy_tpu_torch.data.hcs import HCSDataModule
from viscy_tpu_torch.data.sliding_window import SlidingWindowDataset
from viscy_tpu_torch.data.utils import read_norm_meta
from viscy_tpu_torch.zarr_io.store import open_ome_zarr

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["MmappedDataModule", "MmappedDataset", "stage_to_mmap"]


def _fingerprint(data_path: Path, channels: list[str], positions: list[str]) -> str:
    h = hashlib.sha1()
    h.update(str(data_path.resolve()).encode())
    h.update(json.dumps(channels).encode())
    h.update(json.dumps(positions).encode())
    return h.hexdigest()[:16]


def _views(mm: np.memmap, offsets, fov_shapes) -> list[np.ndarray]:
    return [mm[offsets[i] : offsets[i + 1]].reshape(shape) for i, shape in enumerate(fov_shapes)]


def stage_to_mmap(
    data_path: str | Path,
    channels: Sequence[str],
    scratch_dir: str | Path | None = None,
    include_fov_names: Sequence[str] | None = None,
) -> tuple[list[np.ndarray], Path]:
    """Stage ``channels`` of the plate's FOVs (those in
    ``include_fov_names`` when given, in plate order) to a memmap.

    Returns ``(views, cache_dir)``: one (T, C, Z, Y, X) float32 view per FOV.
    ``scratch_dir`` defaults to the system's temporary directory."""
    data_path = Path(data_path)
    plate = open_ome_zarr(data_path, mode="r")
    positions, names = [], []
    for name, pos in plate.positions():
        if include_fov_names is not None and name not in include_fov_names:
            continue
        positions.append(pos)
        names.append(name)
    ch_idx = [positions[0].get_channel_index(c) for c in channels]

    scratch = Path(tempfile.gettempdir() if scratch_dir is None else scratch_dir)
    if "SLURM_JOB_ID" in os.environ:
        scratch = scratch / os.environ["SLURM_JOB_ID"]
    cache_dir = scratch / f"viscy_mmap_{_fingerprint(data_path, list(channels), names)}"
    done = cache_dir / ".done"
    meta_path = cache_dir / "meta.json"

    fov_shapes = [(s[0], len(ch_idx), *s[2:]) for s in (tuple(p["0"].shape) for p in positions)]
    offsets = np.concatenate([[0], np.cumsum([int(np.prod(s)) for s in fov_shapes])])
    total = int(offsets[-1])

    if done.exists() and meta_path.exists() and json.loads(meta_path.read_text()).get("total") == total:
        _logger.info(f"Reusing mmap cache at {cache_dir}")
        mm = np.memmap(cache_dir / "data.mmap", np.float32, "r", shape=(total,))
        return _views(mm, offsets, fov_shapes), cache_dir
    if cache_dir.exists():
        _logger.warning(f"Rebuilding partial mmap cache at {cache_dir}")
        shutil.rmtree(cache_dir)
    cache_dir.mkdir(parents=True)
    try:
        mm = np.memmap(cache_dir / "data.mmap", np.float32, "w+", shape=(total,))
        for i, pos in enumerate(positions):
            mm[offsets[i] : offsets[i + 1]] = pos["0"].oindex[:, ch_idx].astype(np.float32).reshape(-1)
        mm.flush()
        meta_path.write_text(json.dumps({"total": total, "fovs": names}))
        done.touch()
    except BaseException:
        shutil.rmtree(cache_dir, ignore_errors=True)
        raise
    return _views(mm, offsets, fov_shapes), cache_dir


class MmappedDataset:
    """Dataset over staged memmap volumes: one sample per (FOV, timepoint),
    the whole (C, Z, Y, X) volume as float32, with the FOV's normalization
    metadata and an optional per-sample ``transform`` (the FCMAE
    pretraining access pattern)."""

    def __init__(
        self,
        views: list[np.ndarray],
        positions: list | None = None,
        transform=None,
        load_normalization_metadata: bool = True,
        channel_names: list[str] | None = None,
    ) -> None:
        self.views = views
        self.positions = positions or [None] * len(views)
        self.transform = transform
        self.load_normalization_metadata = load_normalization_metadata
        self.channel_names = channel_names
        self._index = [(f, t) for f, v in enumerate(views) for t in range(v.shape[0])]

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> dict:
        f, t = self._index[idx]
        sample = {"source": np.asarray(self.views[f][t], np.float32)}
        pos = self.positions[f]
        if self.load_normalization_metadata and pos is not None:
            sample["norm_meta"] = read_norm_meta(pos)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class MmappedDataModule(HCSDataModule):
    """``HCSDataModule`` whose fit and validation windows come from a staged
    memmap (``prepare_data`` stages it; ``scratch_dir`` defaults to the
    system's temporary directory). Raises on ``exclude_fov_names`` (see the
    module docstring)."""

    def __init__(self, *args, scratch_dir: str | Path | None = None, **kwargs) -> None:
        kwargs.pop("mmap_preload", None)
        super().__init__(*args, **kwargs)
        if self.exclude_fov_names:
            raise ValueError(
                "MmappedDataModule does not take exclude_fov_names: the reference module stages the FOVs "
                "filtered by include_fov_names alone and pairs them by index with the FOVs left after the "
                "exclusions, so FOVs after an excluded one would train on another FOV's volume; list the "
                "FOVs to keep in include_fov_names instead"
            )
        self._scratch_dir = scratch_dir
        self.caching = False  # staging replaces the RAM preload

    def prepare_data(self) -> None:
        include = set(self.include_fov_names) if self.include_fov_names else None
        names = [n for n, _ in open_ome_zarr(self.data_path, mode="r").positions()]
        self._mmap_views, self._cache_dir = stage_to_mmap(
            self.data_path,
            self.source_channel + self.target_channel,
            self._scratch_dir,
            include_fov_names=[n for n in names if include is None or n in include],
        )

    def _setup_fit(self) -> None:
        if not hasattr(self, "_mmap_views"):
            self.prepare_data()
        positions = self._filtered_positions(open_ome_zarr(self.data_path, mode="r"))
        order = np.random.default_rng(self.seed).permutation(len(positions))
        positions = [positions[i] for i in order]
        views = [self._mmap_views[i] for i in order]
        num_train = int(len(positions) * self.split_ratio)
        if len(positions) >= 2:
            num_train = min(max(num_train, 1), len(positions) - 1)
        train_transform, val_transform = self._fit_transforms()
        settings = self._dataset_settings()
        self.train_dataset = SlidingWindowDataset(
            positions[:num_train], transform=train_transform, preloaded_fovs=views[:num_train], **settings
        )
        self.val_dataset = SlidingWindowDataset(
            positions[num_train:], transform=val_transform, preloaded_fovs=views[num_train:], **settings
        )
