"""Sliding-window datasets over HCS OME-Zarr positions (counterpart of
``viscy_tpu/data/sliding_window.py``'s ``SlidingWindowDataset`` and
``MaskTestDataset``).

Each item is a (C, Z, Y, X) window keyed by a global index into the
cumulative (FOV, t, z-window) table, read with an orthogonal selection of
the port's zarr reader. Each item draws from
``numpy.random.default_rng((seed, epoch, index))``, as the JAX dataset
does, so its samples equal the JAX package's bit for bit. With a RAM
preload and the weighted crop as the only host transform, the crop is
pushed down: origins come from a cached window-sum CDF of the preloaded
weight channel and only the crops are copied, by host kernel H1
(:func:`viscy_tpu_torch.native.batched_crop_normalize`) where the preloaded
FOV is C-contiguous float32 (or uint16 under ``keep_dtype``), as in JAX;
``crop_threads`` is its thread count a call (0: one a hardware thread).
"""

from __future__ import annotations

import bisect
import logging
import re
from pathlib import Path

import numpy as np

from viscy_tpu_torch.data.png import read_label_png
from viscy_tpu_torch.data.typing import ChannelMap, HCSStackIndex
from viscy_tpu_torch.data.utils import ensure_channel_list, read_norm_meta
from viscy_tpu_torch.zarr_io.store import ImageArray, Position

_logger = logging.getLogger("viscy_tpu_torch")


class SlidingWindowDataset:
    """Sliding windows along (T, Z) of each FOV."""

    def __init__(
        self,
        positions: list[Position],
        channels: ChannelMap,
        z_window_size: int,
        array_key: str = "0",
        transform=None,
        load_normalization_metadata: bool = True,
        min_nonzero_fraction: float = 0.0,
        nonzero_threshold: float = 0.0,
        nonzero_channel: str | None = None,
        max_nonzero_retries: int = 100,
        preloaded_fovs: list[np.ndarray] | None = None,
        fg_mask_key: str | None = None,
        pushdown_crop=None,
        seed: int = 42,
        keep_dtype: bool = False,
        crop_threads: int = 0,
    ) -> None:
        if not 0.0 <= min_nonzero_fraction <= 1.0:
            raise ValueError(f"min_nonzero_fraction must be in [0, 1], got {min_nonzero_fraction}")
        self.positions = positions
        self.channels = {k: ensure_channel_list(v) for k, v in channels.items()}
        self.source_ch_idx = [positions[0].get_channel_index(c) for c in self.channels["source"]]
        self.target_ch_idx = (
            [positions[0].get_channel_index(c) for c in self.channels["target"]]
            if "target" in self.channels
            else None
        )
        self.z_window_size = z_window_size
        self.transform = transform
        self.array_key = array_key
        self.load_normalization_metadata = load_normalization_metadata
        self.min_nonzero_fraction = min_nonzero_fraction
        self.nonzero_threshold = nonzero_threshold
        self.nonzero_channel = nonzero_channel
        self.max_nonzero_retries = max_nonzero_retries
        self.fg_mask_key = fg_mask_key
        self.pushdown_crop = pushdown_crop
        self._origin_cdf_cache: dict = {}
        self.seed = seed
        self.keep_dtype = keep_dtype
        self.crop_threads = crop_threads
        self._all_ch_names = list(self.channels["source"])
        self._all_ch_idx = list(self.source_ch_idx)
        if self.target_ch_idx is not None:
            self._all_ch_names += list(self.channels["target"])
            self._all_ch_idx += list(self.target_ch_idx)
        self._preloaded = preloaded_fovs
        self._get_windows()
        if nonzero_channel is not None and nonzero_channel not in self._all_ch_names:
            raise ValueError(f"nonzero_channel {nonzero_channel!r} not found in {self._all_ch_names}")

    def _get_windows(self) -> None:
        w = 0
        self.window_keys: list[int] = []
        self.window_arrays: list[ImageArray] = []
        self.window_norm_meta: list[dict | None] = []
        for fov in self.positions:
            img = fov[str(self.array_key)]
            zs = img.slices - self.z_window_size + 1
            if zs < 1:
                raise IndexError(
                    f"Z window size {self.z_window_size} larger than Z slices "
                    f"({img.slices}) for FOV {img.path}."
                )
            w += img.frames * zs
            self.window_keys.append(w)
            self.window_arrays.append(img)
            self.window_norm_meta.append(read_norm_meta(fov))
        self._max_window = w

    def _find_window(self, index: int) -> tuple[ImageArray, int, dict | None, int]:
        arr_idx = bisect.bisect_right(self.window_keys, index)
        tz = index - self.window_keys[arr_idx - 1] if arr_idx > 0 else index
        return self.window_arrays[arr_idx], tz, self.window_norm_meta[arr_idx], arr_idx

    def _tz(self, img: ImageArray, tz: int) -> tuple[int, int]:
        zs = img.shape[-3] - self.z_window_size + 1
        t = (tz + zs) // zs - 1
        return t, tz - t * zs

    @staticmethod
    def _resolve_timepoint_norm_meta(norm_meta: dict | None, t: int) -> dict | None:
        if norm_meta is None:
            return None
        return {
            ch: {
                name: values[str(t)] if name == "timepoint_statistics" else values
                for name, values in levels.items()
            }
            for ch, levels in norm_meta.items()
        }

    def _read_img_window(
        self, img: ImageArray, ch_idx: list[int], tz: int, arr_idx: int = -1
    ) -> tuple[np.ndarray, HCSStackIndex]:
        """A (C, Z, Y, X) window and its (path, t, z)."""
        t, z = self._tz(img, tz)
        if self._preloaded is not None and arr_idx >= 0:
            window = self._preloaded[arr_idx][t, :, z : z + self.z_window_size]
            data = window.astype(window.dtype if self.keep_dtype else np.float32, copy=True)
        else:
            raw = img.oindex[slice(t, t + 1), [int(i) for i in ch_idx], slice(z, z + self.z_window_size)]
            data = raw.astype(raw.dtype if self.keep_dtype else np.float32, copy=False)[0]
        return data, HCSStackIndex(f"/{img.path}", t, z)

    def __len__(self) -> int:
        return self._max_window

    def __getitem__(self, index: int):
        return self.get_item_with_epoch(index, 0)

    def get_item_with_epoch(self, index: int, epoch: int):
        """The item of ``index`` with the random stream of (seed, epoch, index)."""
        rng = np.random.default_rng((self.seed, epoch, index))
        if self.pushdown_crop is not None and self._preloaded is not None:
            return self._get_item_pushdown(index, rng)
        check_key = (
            (self.nonzero_channel or self.channels.get("target", [None])[0])
            if self.min_nonzero_fraction > 0
            else None
        )
        idx = index
        for attempt in range(self.max_nonzero_retries + 1):
            img, tz, norm_meta, arr_idx = self._find_window(idx)
            data, sample_index = self._read_img_window(img, self._all_ch_idx, tz, arr_idx)
            sample_images = {name: data[i : i + 1] for i, name in enumerate(self._all_ch_names)}
            if check_key is not None and check_key in sample_images:
                patch = sample_images[check_key]
                frac = (patch >= self.nonzero_threshold).sum() / patch.size
                if frac < self.min_nonzero_fraction:
                    if attempt < self.max_nonzero_retries:
                        idx = int(rng.integers(0, len(self)))
                        continue
                    _logger.warning(
                        f"Exhausted {self.max_nonzero_retries} retries for nonzero "
                        f"fraction >= {self.min_nonzero_fraction} on {check_key!r} "
                        f"(index {index}). Returning last sample."
                    )
            break
        mask_keys = []
        if self.fg_mask_key is not None and self.target_ch_idx is not None:
            # foreground masks of the target channels, as per-channel keys
            # so spatial host transforms move them with the images
            img_pos, tz2, _, _ = self._find_window(idx)
            fov = self.positions[self.window_arrays.index(img_pos)]
            mask_arr = fov[self.fg_mask_key]
            t2, z2 = self._tz(mask_arr, tz2)
            masks = mask_arr.oindex[
                slice(t2, t2 + 1),
                [int(i) for i in self.target_ch_idx],
                slice(z2, z2 + self.z_window_size),
            ].astype(np.float32)[0]
            for i, ch in enumerate(self.channels["target"]):
                key = f"fg_mask_{ch}"
                sample_images[key] = masks[i : i + 1]
                mask_keys.append(key)
        if self.target_ch_idx is not None:
            # the first target channel weighs the weighted crop
            sample_images["weight"] = sample_images[self.channels["target"][0]]
        if norm_meta is not None:
            norm_meta = self._resolve_timepoint_norm_meta(norm_meta, sample_index.time)
            sample_images["norm_meta"] = norm_meta
        if self.transform:
            sample_images = self.transform(sample_images, rng)
        multi = isinstance(sample_images, list)
        out = []
        for p in sample_images if multi else [sample_images]:
            p.pop("weight", None)
            sample = {"index": sample_index, "source": self._stack_channels(p, "source")}
            if self.target_ch_idx is not None:
                sample["target"] = self._stack_channels(p, "target")
            if mask_keys:
                sample["fg_mask"] = np.concatenate([p[k] for k in mask_keys], axis=0)
            if self.load_normalization_metadata and norm_meta is not None:
                sample["norm_meta"] = norm_meta
            out.append(sample)
        return out if multi else out[0]

    def _stack_channels(self, sample_images: dict, key: str) -> np.ndarray:
        return np.concatenate([sample_images[ch] for ch in self.channels[key]], axis=0)

    def _get_item_pushdown(self, index: int, rng: np.random.Generator):
        """Weighted-crop origins from a view of the preloaded FOV, then a
        copy of the crop regions only."""
        crop = self.pushdown_crop
        img, tz, norm_meta, arr_idx = self._find_window(index)
        t, z = self._tz(img, tz)
        view = self._preloaded[arr_idx]  # (T, C, Z, Y, X), channels = source + target
        slab = view[t, :, z : z + self.z_window_size]
        n_source = len(self.channels["source"])
        cz, cy, cx = crop.spatial_size
        cz = min(cz, slab.shape[1])
        # the weight volume does not change across epochs: cache its
        # window-sum CDF per (fov, t, z)
        cache_key = (arr_idx, t, z)
        cdf_vx = self._origin_cdf_cache.get(cache_key)
        if cdf_vx is None:
            if len(self._origin_cdf_cache) >= 512:
                self._origin_cdf_cache.clear()
            cdf_vx = _weighted_origin_cdf(slab[n_source], (cy, cx))
            self._origin_cdf_cache[cache_key] = cdf_vx
        origins = _sample_origins_from_cdf(*cdf_vx, crop.num_samples, rng)
        if norm_meta is not None:
            norm_meta = self._resolve_timepoint_norm_meta(norm_meta, t)
        sample_index = HCSStackIndex(f"/{img.path}", t, z)
        full = view[t]
        z_full = cz >= slab.shape[1]
        origins3 = np.array(
            [(z + (0 if z_full else int(rng.integers(0, slab.shape[1] - cz + 1))), ys, xs) for ys, xs in origins],
            np.int64,
        )
        if full.flags["C_CONTIGUOUS"] and (
            full.dtype == np.float32 or (self.keep_dtype and full.dtype == np.uint16)
        ):
            from viscy_tpu_torch.native import batched_crop_normalize

            patches = batched_crop_normalize(full, origins3, (cz, cy, cx), n_threads=self.crop_threads)
        else:
            patch_dtype = full.dtype if self.keep_dtype else np.float32
            patches = np.stack(
                [
                    np.ascontiguousarray(full[:, z0 : z0 + cz, y0 : y0 + cy, x0 : x0 + cx], dtype=patch_dtype)
                    for z0, y0, x0 in origins3
                ]
            )
        out = []
        for patch in patches:
            sample = {"index": sample_index, "source": patch[:n_source]}
            if self.target_ch_idx is not None:
                sample["target"] = patch[n_source:]
            if self.load_normalization_metadata and norm_meta is not None:
                sample["norm_meta"] = norm_meta
            out.append(sample)
        return out if len(out) > 1 else out[0]


def _weighted_origin_cdf(weight: np.ndarray, crop_yx: tuple[int, int]) -> tuple[np.ndarray, int]:
    """Cumulative distribution over the valid crop origins, proportional to
    the window-summed (Z-reduced) weight, via an integral image."""
    cy, cx = crop_yx
    wm = np.clip(weight.sum(axis=0, dtype=np.float32), 0, None)
    integral = np.pad(wm, ((1, 0), (1, 0))).cumsum(0).cumsum(1)
    vy, vx = wm.shape[0] - cy + 1, wm.shape[1] - cx + 1
    window = (
        integral[cy:, cx:][:vy, :vx]
        - integral[:-cy, cx:][:vy, :vx]
        - integral[cy:, :-cx][:vy, :vx]
        + integral[:-cy, :-cx][:vy, :vx]
    )
    flat = np.clip(window.reshape(-1).astype(np.float64), 0, None)
    total = flat.sum()
    if total <= 0:
        flat = np.ones_like(flat)
        total = flat.size
    return np.cumsum(flat / total), vx


def _sample_origins_from_cdf(
    cdf: np.ndarray, vx: int, num_samples: int, rng: np.random.Generator
) -> list[tuple[int, int]]:
    """Inverse-CDF sampling of ``num_samples`` (y, x) origins."""
    idx = np.minimum(np.searchsorted(cdf, rng.random(num_samples), side="right"), cdf.size - 1)
    return [(int(i) // vx, int(i) % vx) for i in idx]


class MaskTestDataset(SlidingWindowDataset):
    """The test stage's dataset, with ground-truth masks where there are
    some (counterpart of ``viscy_tpu/data/sliding_window.py``'s
    ``MaskTestDataset``): PNG files named ``*_p###_z#_cp_masks.png`` in
    ``ground_truth_masks`` are matched by (position, t = 0, center z of the
    window); a matching window's sample gains ``labels``, the mask as
    ``np.int16`` (read by :mod:`viscy_tpu_torch.data.png`)."""

    def __init__(
        self,
        positions: list[Position],
        channels: ChannelMap,
        z_window_size: int,
        transform=None,
        ground_truth_masks: str | None = None,
        array_key: str = "0",
        **kwargs,
    ) -> None:
        super().__init__(positions, channels, z_window_size, array_key=array_key, transform=transform, **kwargs)
        self.masks: dict[tuple[int, int, int], str] = {}
        if ground_truth_masks is None:
            return
        for img_path in Path(ground_truth_masks).glob("*cp_masks.png"):
            pos = re.search(r"(?<=_p)\d{3}", img_path.name)
            z = re.search(r"(?<=_z)\d+", img_path.name)
            if pos and z:
                self.masks[(int(pos.group()), 0, int(z.group()))] = str(img_path)

    def get_item_with_epoch(self, index: int, epoch: int):
        sample = super().get_item_with_epoch(index, epoch)
        if not self.masks or isinstance(sample, list):
            return sample
        img_name, t_idx, z_idx = sample["index"]
        key = (int(img_name.split("/")[-2]), int(t_idx), int(z_idx) + self.z_window_size // 2)
        if path := self.masks.get(key):
            sample["labels"] = read_label_png(path)
        return sample
