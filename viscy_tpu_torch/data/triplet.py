"""Triplet dataset and datamodule for contrastive learning from tracked cells
(counterpart of ``viscy_tpu/data/triplet.py``; reference
``viscy_data/triplet.py:53,290``).

Anchors are the rows of the per-FOV tracking CSVs (read without pandas,
:mod:`viscy_tpu_torch.data._tracks`) whose cell lies more than half a patch
from the image border (and, with an integer ``time_interval``, whose track
has a row ``time_interval`` frames later); the positive is the same track
at ``t + time_interval`` (or the anchor's own window when
``time_interval="any"``), the negative a cell of another track drawn from a
numpy Generator the dataset keeps. A batch reads each cell's
``(C, Z, Y, X)`` window through the port's OME-Zarr reader, as float32.

On the device (``device_transform``) each view (anchor, positive,
negative) is normalized and augmented on its own draws, then center-cropped
to ``(z_window_size, *final_yx_patch_size)``; the crop is a member of the
view's ``Compose``, so the affine+crop and smooth+crop fusions apply.

In a job of several processes the train and validation loaders give each
rank its rows of the global batch one process would draw (the JAX loader
reads the same cells on every process: ROADMAP.md Queue 3); each rank's
dataset draws the negatives of its own rows.
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal, Sequence

import numpy as np
import torch

from viscy_tpu_torch.data._tracks import merge_inner, read_tracks_csv, rows_with_partner
from viscy_tpu_torch.data.hcs import DataModule
from viscy_tpu_torch.data.typing import ULTRACK_INDEX_COLUMNS
from viscy_tpu_torch.data.utils import read_norm_meta
from viscy_tpu_torch.evaluation.anndata_lite import Frame
from viscy_tpu_torch.parallel.distributed import process_count, process_index
from viscy_tpu_torch.transforms.base import Compose
from viscy_tpu_torch.transforms.crop import BatchedCenterSpatialCropd
from viscy_tpu_torch.zarr_io.store import Position, open_ome_zarr

VIEWS = ("anchor", "positive", "negative")


def _collate_norms(norms: list[dict | None]) -> dict | None:
    """Per-sample norm meta dicts as float32 statistic vectors of shape (B,)
    (``timepoint_statistics`` left out)."""
    if not norms or norms[0] is None:
        return None
    out: dict = {}
    for ch in norms[0]:
        out[ch] = {}
        for level in norms[0][ch]:
            if level == "timepoint_statistics":
                continue
            out[ch][level] = {
                stat: np.asarray([n[ch][level][stat] for n in norms], np.float32)
                for stat in norms[0][ch][level]
            }
    return out


class TripletDataset:
    """Triplet sampling of cells from tracking results."""

    def __init__(
        self,
        positions: list[Position],
        tracks_tables: list[Frame],
        channel_names: list[str],
        initial_yx_patch_size: tuple[int, int],
        z_range: slice,
        fit: bool = True,
        predict_cells: bool = False,
        include_fov_names: list[str] | None = None,
        include_track_ids: list[int] | None = None,
        time_interval: Literal["any"] | int = "any",
        return_negative: bool = True,
        seed: int = 42,
    ) -> None:
        if not positions:
            raise ValueError("TripletDataset needs at least one FOV (no objects to concatenate)")
        self.positions = positions
        self.channel_names = channel_names
        self.channel_indices = [positions[0].get_channel_index(c) for c in channel_names]
        self.z_range = z_range
        self.fit = fit
        self.yx_patch_size = tuple(initial_yx_patch_size)
        self.predict_cells = predict_cells
        self.include_fov_names = include_fov_names or []
        self.include_track_ids = include_track_ids or []
        self.time_interval = time_interval
        self.return_negative = return_negative
        self.rng = np.random.default_rng(seed)
        self.tracks = self._filter_tracks(tracks_tables)
        if self.predict_cells:
            self.tracks = self._specific_cells(self.tracks)
        self.valid_anchors = self._filter_anchors(self.tracks)
        # integer codes of global_track_id (negatives compare them per anchor)
        gids = self.tracks["global_track_id"].tolist()
        self._code_of = {g: i for i, g in enumerate(dict.fromkeys(gids))}
        self._track_codes = np.asarray([self._code_of[g] for g in gids], dtype=np.int64)
        self._norm_meta = [read_norm_meta(p) for p in positions]

    # -- track filtering -----------------------------------------------------
    def _filter_tracks(self, tracks_tables: list[Frame]) -> Frame:
        """Each FOV's rows with ``position_idx``, ``fov_name`` (the last three
        parts of the FOV's path) and ``global_track_id`` added, kept where
        the cell lies strictly inside the border margin."""
        filtered = []
        y_ex, x_ex = self.yx_patch_size[0] // 2, self.yx_patch_size[1] // 2
        for pos_idx, (pos, tracks) in enumerate(zip(self.positions, tracks_tables, strict=True)):
            n = len(tracks)
            fov_name = "/".join(str(pos.path).split("/")[-3:])
            gid = np.empty(n, dtype=object)
            gid[:] = [f"{fov_name}_{i}" for i in tracks["track_id"].tolist()]
            tracks = Frame({**tracks.columns, "position_idx": np.full(n, pos_idx, np.int64),
                            "fov_name": np.full(n, fov_name, dtype=object), "global_track_id": gid})
            image = pos["0"]
            if self.z_range.stop > image.slices:
                raise ValueError(f"Z range {self.z_range} exceeds image with Z={image.slices}")
            y, x = tracks["y"], tracks["x"]
            inside = (y > y_ex) & (y < image.height - y_ex) & (x > x_ex) & (x < image.width - x_ex)
            filtered.append(tracks.take(inside))
        return Frame.concat(filtered)

    def _filter_anchors(self, tracks: Frame) -> Frame:
        if self.time_interval == "any" or not self.fit:
            return tracks
        if len(tracks) == 0:
            raise ValueError("no tracks left to draw anchors from (no objects to concatenate)")
        return rows_with_partner(tracks, self.time_interval)

    def _specific_cells(self, tracks: Frame) -> Frame:
        """The rows of each ``(include_fov_names[i], include_track_ids[i])``
        pair, pair by pair. Without pairs the JAX dataset selects no cell
        (an empty predict); the port raises instead."""
        if not self.include_fov_names or not self.include_track_ids:
            raise ValueError(
                "predict_cells=True embeds only the (fov_name, track_id) pairs of include_fov_names and "
                "include_track_ids, and none were given: set them, or predict_cells: false to embed every cell"
            )
        parts = [
            np.flatnonzero((tracks["fov_name"] == fov_name) & (tracks["track_id"] == track_id))
            for fov_name, track_id in zip(self.include_fov_names, self.include_track_ids)
        ]
        return tracks.take(np.concatenate(parts))

    def __len__(self) -> int:
        return len(self.valid_anchors)

    # -- sampling -----------------------------------------------------------
    def _sample_positives(self, anchor_rows: Frame) -> Frame:
        """The rows of each anchor's track at ``t + time_interval``, anchor by
        anchor (an inner merge: a track with two rows at that frame gives
        two positives, one with none gives none)."""
        query = zip(anchor_rows["global_track_id"].tolist(), (anchor_rows["t"] + self.time_interval).tolist())
        right = zip(self.tracks["global_track_id"].tolist(), self.tracks["t"].tolist())
        return merge_inner(query, self.tracks, right)

    def _sample_negatives(self, anchor_rows: Frame) -> Frame:
        """One row of another track per anchor, one ``rng.integers`` draw per
        anchor in anchor order (candidates in table order; with an integer
        ``time_interval`` only rows at the anchor's ``t + time_interval``)."""
        codes = self._track_codes
        picks = []
        for gid, t in zip(anchor_rows["global_track_id"].tolist(), anchor_rows["t"].tolist()):
            other = codes != self._code_of.get(gid, -1)
            if self.time_interval != "any":
                other &= self.tracks["t"] == t + self.time_interval
            candidates = np.flatnonzero(other)
            picks.append(candidates[int(self.rng.integers(0, len(candidates)))])
        return self.tracks.take(np.asarray(picks, dtype=np.int64))

    # -- IO -------------------------------------------------------------------
    def _slice_patches(self, rows: Frame) -> tuple[np.ndarray, list]:
        """The rows' ``(C, Z, Y, X)`` windows stacked as float32, and each
        row's FOV norm meta."""
        y_half, x_half = (d // 2 for d in self.yx_patch_size)
        windows, norms = [], []
        for p, t, y, x in zip(*(rows[k].tolist() for k in ("position_idx", "t", "y", "x"))):
            image = self.positions[p]["0"]
            windows.append(
                image.oindex[t, self.channel_indices, self.z_range, slice(y - y_half, y + y_half),
                             slice(x - x_half, x + x_half)]
            )
            norms.append(self._norm_meta[p])
        return np.stack(windows).astype(np.float32, copy=False), norms

    def __getitems__(self, indices: list[int]) -> dict:
        anchor_rows = self.valid_anchors.take(np.asarray(indices, dtype=np.int64))
        anchor_patches, anchor_norms = self._slice_patches(anchor_rows)
        sample = {"anchor": anchor_patches, "anchor_norm_meta": _collate_norms(anchor_norms)}
        if self.fit:
            if self.time_interval == "any":
                sample["positive"] = anchor_patches.copy()
                sample["positive_norm_meta"] = _collate_norms(anchor_norms)
            else:
                pos_patches, pos_norms = self._slice_patches(self._sample_positives(anchor_rows))
                sample["positive"] = pos_patches
                sample["positive_norm_meta"] = _collate_norms(pos_norms)
            if self.return_negative:
                neg_patches, neg_norms = self._slice_patches(self._sample_negatives(anchor_rows))
                sample["negative"] = neg_patches
                sample["negative_norm_meta"] = _collate_norms(neg_norms)
        else:
            columns = [c for c in ULTRACK_INDEX_COLUMNS if c in anchor_rows]
            sample["index"] = [{c: anchor_rows[c][i] for c in columns} for i in range(len(anchor_rows))]
        return sample


class TripletDataModule(DataModule):
    """Datamodule for triplet sampling (reference ``triplet.py:290``): the
    JAX datamodule's keyword arguments; ``num_workers``,
    ``persistent_workers``, ``prefetch_factor``, ``pin_memory`` and
    ``cache_pool_bytes`` are accepted for config compatibility and do
    nothing, as there (the trainer's prefetcher reads batches ahead).

    Unlike the JAX trainer, the port's ``Trainer.predict`` runs
    ``device_transform`` on predict batches (``predict_device_transform``):
    the embedded windows are normalized and center-cropped, as the
    reference's ``on_after_batch_transfer`` does in every stage."""

    predict_device_transform = True

    def __init__(
        self,
        data_path: str,
        tracks_path: str,
        source_channel: str | Sequence[str],
        z_range: tuple[int, int],
        initial_yx_patch_size: tuple[int, int] = (512, 512),
        final_yx_patch_size: tuple[int, int] = (224, 224),
        split_ratio: float = 0.8,
        batch_size: int = 16,
        num_workers: int = 1,
        normalizations: list | None = None,
        augmentations: list | None = None,
        augment_validation: bool = True,
        fit_include_wells: list[str] | None = None,
        fit_exclude_fovs: list[str] | None = None,
        predict_cells: bool = False,
        include_fov_names: list[str] | None = None,
        include_track_ids: list[int] | None = None,
        time_interval: Literal["any"] | int = "any",
        return_negative: bool = True,
        z_window_size: int | None = None,
        seed: int = 42,
        device_aug_chunk: int | None = None,
        persistent_workers: bool = False,
        prefetch_factor: int | None = None,
        pin_memory: bool = False,
        cache_pool_bytes: int = 0,
    ) -> None:
        self.data_path = Path(data_path)
        self.tracks_path = Path(tracks_path)
        self.source_channel = [source_channel] if isinstance(source_channel, str) else list(source_channel)
        self.z_range = slice(*z_range)
        self.initial_yx_patch_size = tuple(initial_yx_patch_size)
        self.final_yx_patch_size = tuple(final_yx_patch_size)
        self.split_ratio = split_ratio
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.normalizations = list(normalizations or [])
        self.augmentations = list(augmentations or [])
        self.augment_validation = augment_validation
        self._include_wells = fit_include_wells
        self._exclude_fovs = fit_exclude_fovs
        self.predict_cells = predict_cells
        self.include_fov_names = include_fov_names
        self.include_track_ids = include_track_ids
        self.time_interval = time_interval
        self.return_negative = return_negative
        self.z_window_size = z_window_size or (z_range[1] - z_range[0])
        self.seed = seed
        # run a view's normalize + augment in chunks of at most this many
        # samples (the largest divisor of the batch); None = one shot
        self.device_aug_chunk = device_aug_chunk
        self._epoch = 0
        crop = BatchedCenterSpatialCropd(keys=self.source_channel,
                                         roi_size=(self.z_window_size, *self.final_yx_patch_size))
        self._aug_compose = Compose([*Compose(self.normalizations + self.augmentations).transforms, crop])
        self._norm_compose = Compose([*Compose(self.normalizations).transforms, crop])

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _align_tracks_tables_with_positions(self) -> tuple[list[Position], list[Frame]]:
        """The plate's FOVs (``fit_include_wells`` / ``fit_exclude_fovs``
        applied) and the first CSV (sorted) of ``tracks_path/<row>/<col>/<fov>``
        of each; a FOV without one raises ``FileNotFoundError``."""
        positions, tracks_tables = [], []
        plate = open_ome_zarr(self.data_path, mode="r")
        for name, fov in plate.positions():
            well = "/".join(name.split("/")[:2])
            if self._include_wells is not None and well not in self._include_wells:
                continue
            if self._exclude_fovs is not None and name in self._exclude_fovs:
                continue
            csvs = sorted((self.tracks_path / name).glob("*.csv"))
            if not csvs:
                raise FileNotFoundError(f"No tracks CSV for FOV {name}")
            positions.append(fov)
            tracks_tables.append(read_tracks_csv(csvs[0]))
        return positions, tracks_tables

    def _dataset_kwargs(self) -> dict:
        return dict(channel_names=self.source_channel, z_range=self.z_range, time_interval=self.time_interval,
                    seed=self.seed, initial_yx_patch_size=self.initial_yx_patch_size)

    def setup(self, stage: str) -> None:
        """``fit`` / ``validate``: the FOVs in a seeded permutation, the first
        ``int(n * split_ratio)`` for training and the rest for validation;
        ``predict``: every FOV (``predict_cells`` selects cells)."""
        if stage in ("fit", "validate"):
            positions, tracks = self._align_tracks_tables_with_positions()
            order = np.random.default_rng(self.seed).permutation(len(positions))
            positions = [positions[i] for i in order]
            tracks = [tracks[i] for i in order]
            num_train = int(len(positions) * self.split_ratio)
            kwargs = dict(fit=True, return_negative=self.return_negative, **self._dataset_kwargs())
            self.train_dataset = TripletDataset(positions[:num_train], tracks[:num_train], **kwargs)
            self.val_dataset = TripletDataset(positions[num_train:], tracks[num_train:], **kwargs)
        elif stage == "predict":
            positions, tracks = self._align_tracks_tables_with_positions()
            self.predict_dataset = TripletDataset(
                positions, tracks, fit=False, predict_cells=self.predict_cells,
                include_fov_names=self.include_fov_names, include_track_ids=self.include_track_ids,
                **self._dataset_kwargs(),
            )
        else:
            raise NotImplementedError(stage)

    def train_dataloader(self) -> "_BatchedTripletLoader":
        return _BatchedTripletLoader(self.train_dataset, self.batch_size, shuffle=True, seed=self.seed,
                                     epoch=self._epoch)

    def val_dataloader(self) -> "_BatchedTripletLoader":
        return _BatchedTripletLoader(self.val_dataset, self.batch_size, shuffle=False, seed=self.seed)

    def predict_dataloader(self) -> "_BatchedTripletLoader":
        """Every cell, the last batch short: the JAX loader drops the last
        ``len % batch_size`` cells from the embedding store."""
        return _BatchedTripletLoader(self.predict_dataset, self.batch_size, shuffle=False, seed=self.seed,
                                     drop_last=False, distributed=False)

    # -- device-side normalization + augmentation ------------------------------------
    def _chunk(self, b: int) -> int:
        """Samples per chunk: the largest divisor of ``b`` at most
        ``device_aug_chunk`` (``b``: one shot)."""
        chunk = self.device_aug_chunk
        if not chunk or chunk >= b:
            return b
        while b % chunk:
            chunk -= 1
        return chunk

    def _transform_chunk(self, patches: torch.Tensor, norm_meta, transform: Compose, generator, draws):
        sample = {name: patches[:, i : i + 1] for i, name in enumerate(self.source_channel)}
        if norm_meta is not None:
            sample["norm_meta"] = norm_meta
        sample = transform(sample, generator, draws)
        return torch.cat([sample[name] for name in self.source_channel], dim=1)

    def _transform_one(self, patches: torch.Tensor, norm_meta, transform: Compose, generator, draws):
        """One view through ``transform``, in chunks of :meth:`_chunk`
        samples (each chunk draws on its own; ``draws`` is then one list of
        member draws per chunk)."""
        b = patches.shape[0]
        chunk = self._chunk(b)
        if chunk == b:
            return self._transform_chunk(patches, norm_meta, transform, generator, draws)
        outs = []
        for i, s in enumerate(range(0, b, chunk)):
            meta = None if norm_meta is None else _slice_meta(norm_meta, slice(s, s + chunk))
            outs.append(self._transform_chunk(patches[s : s + chunk], meta, transform, generator,
                                              None if draws is None else draws[i]))
        return torch.cat(outs)

    def device_transform(
        self,
        batch: dict,
        generator: torch.Generator | None = None,
        stage: str = "train",
        draws: dict | None = None,
    ) -> dict:
        """Normalize (``normalizations``) and, in training and in validation
        with ``augment_validation``, augment each view, then center-crop it;
        the anchor, positive and negative views draw from ``generator`` in
        that order, or take ``draws[view]`` (the member draws of the view's
        ``Compose``). The ``*_norm_meta`` entries are consumed; others (the
        predict ``index``) pass through."""
        use_aug = stage == "train" or (stage == "val" and self.augment_validation)
        transform = self._aug_compose if use_aug else self._norm_compose
        out = dict(batch)
        for view in VIEWS:
            if view in batch:
                out[view] = self._transform_one(batch[view], batch.get(f"{view}_norm_meta"), transform, generator,
                                                None if draws is None else draws[view])
        for k in [k for k in out if k.endswith("_norm_meta")]:
            out.pop(k)
        return out


def _slice_meta(node, rows: slice):
    if isinstance(node, dict):
        return {k: _slice_meta(v, rows) for k, v in node.items()}
    return node[rows]


class _BatchedTripletLoader:
    """Batches of ``__getitems__``: shuffled with ``default_rng(seed +
    epoch)``; with ``drop_last``, ``n // batch_size`` full batches (the rest
    dropped) or one short batch when the dataset is smaller than a batch,
    else every row, the last batch short.

    With ``distributed`` in a job of ``world`` processes, ``batch_size`` is
    each rank's: the loader cuts global batches of ``batch_size * world``
    rows from the permutation one process would draw with that batch, and
    rank ``r`` yields rows ``[r * batch_size, (r + 1) * batch_size)`` of
    each, so the ranks' batches together are the one-process batch. A
    global batch that does not divide (the short one) is padded by
    wrapping to a multiple of ``world`` and split evenly."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int = 42, epoch: int = 0,
                 drop_last: bool = True, distributed: bool = True) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.drop_last = drop_last
        self.world = process_count() if distributed else 1
        self.rank = process_index() if distributed else 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        size = self.batch_size * self.world
        if not self.drop_last:
            return -(-len(self.dataset) // size)
        return max(1, len(self.dataset) // size)

    def _rows(self, batch: np.ndarray) -> list:
        """This rank's rows of a global batch."""
        if self.world == 1:
            return list(batch)
        batch = np.resize(batch, -(-len(batch) // self.world) * self.world)
        per = len(batch) // self.world
        return list(batch[self.rank * per : (self.rank + 1) * per])

    def __iter__(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(indices)
        size = self.batch_size * self.world
        n = len(indices) if not self.drop_last else (len(indices) // size) * size
        if n == 0 and len(indices) > 0:
            yield self.dataset.__getitems__(self._rows(indices))
            return
        for i in range(0, n, size):
            yield self.dataset.__getitems__(self._rows(indices[i : i + size]))
