"""Normalization statistics, Otsu thresholds and foreground masks
(counterpart of ``viscy_tpu/preprocess/stats.py``).

Grid-subsampled per-FOV, per-timepoint and dataset statistics go to
``.zattrs["normalization"]`` (what ``NormalizeSampled`` reads); optional
median-filtered Otsu thresholds and uint8 foreground-mask arrays. FOVs are
sampled on worker threads.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
from scipy.ndimage import median_filter

from viscy_tpu_torch.zarr_io.store import open_ome_zarr

_logger = logging.getLogger("viscy_tpu_torch")


def get_val_stats(sample_values) -> dict:
    """Intensity statistics of a sample (12 values)."""
    percentiles = [1, 5, 25, 50, 75, 95, 99]
    pv = {k: float(v) for k, v in zip(percentiles, np.nanpercentile(sample_values, percentiles))}
    return {
        "min": float(np.nanmin(sample_values)),
        "max": float(np.nanmax(sample_values)),
        "mean": float(np.nanmean(sample_values)),
        "std": float(np.nanstd(sample_values)),
        "median": pv[50],
        "iqr": pv[75] - pv[25],
        "p5": pv[5],
        "p95": pv[95],
        "p95_p5": pv[95] - pv[5],
        "p1": pv[1],
        "p99": pv[99],
        "p99_p1": pv[99] - pv[1],
    }


def otsu_threshold(values: np.ndarray, n_bins: int = 256) -> float:
    """Otsu's threshold of a flat array (skimage's rule)."""
    values = np.asarray(values).ravel()
    lo, hi = float(values.min()), float(values.max())
    if lo == hi:
        return lo
    hist, edges = np.histogram(values, bins=n_bins, range=(lo, hi))
    hist = hist.astype(np.float64)
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(hist)
    total = w0[-1]
    w1 = total - w0
    mu0 = np.cumsum(hist * centers)
    mu_total = mu0[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        # between-class variance times total^2 (same argmax)
        var_between = (mu_total * w0 - mu0 * total) ** 2 / (w0 * w1)
    var_between[~np.isfinite(var_between)] = -1
    return float(centers[np.argmax(var_between)])


def write_meta_field(node, metadata: dict, field_name: str, subfield_name: str) -> None:
    """Merge ``metadata`` into ``zattrs[field_name][subfield_name]``."""
    attrs = node.zattrs
    d = attrs.asdict()
    d.setdefault(field_name, {}).setdefault(subfield_name, {}).update(metadata)
    attrs._replace(d)


def _grid_sample(position, grid_spacing: int, channel_index: int) -> np.ndarray:
    return position["0"].oindex[slice(None), [channel_index], slice(None)][
        :, 0, :, ::grid_spacing, ::grid_spacing
    ]


def generate_normalization_metadata(
    zarr_dir: str | Path,
    num_workers: int = 4,
    channel_ids=-1,
    grid_spacing: int = 32,
    compute_otsu: bool = False,
    otsu_grid_spacing: int = 8,
) -> None:
    """Compute and write FOV, timepoint and dataset statistics to zattrs."""
    plate = open_ome_zarr(zarr_dir, mode="r+")
    position_map = list(plate.positions())
    if channel_ids == -1:
        channel_ids = range(len(plate.channel_names))
    elif isinstance(channel_ids, int):
        channel_ids = [channel_ids]
    num_timepoints = position_map[0][1]["0"].shape[0]

    for channel_index in channel_ids:
        channel_name = plate.channel_names[channel_index]
        _logger.info(f"Sampling channel {channel_name}")

        def _fov_stats(item):
            _, pos = item
            samples = _grid_sample(pos, grid_spacing, channel_index)
            fov_stats = get_val_stats(samples)
            if compute_otsu:
                otsu_samples = _grid_sample(pos, otsu_grid_spacing, channel_index)
                fov_stats["otsu_threshold"] = otsu_threshold(median_filter(otsu_samples, size=(1, 1, 3, 3)))
            stats = {
                "fov_statistics": fov_stats,
                "timepoint_statistics": {str(t): get_val_stats(samples[t]) for t in range(num_timepoints)},
            }
            return pos, samples, stats

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            results = list(pool.map(_fov_stats, position_map))
        dataset_samples = [s for _, s, _ in results]
        dataset_statistics = {"dataset_statistics": get_val_stats(np.stack(dataset_samples))}
        dataset_timepoint = {
            str(t): get_val_stats(np.stack([s[t] for s in dataset_samples])) for t in range(num_timepoints)
        }
        write_meta_field(
            plate,
            dataset_statistics | {"timepoint_statistics": dataset_timepoint},
            "normalization",
            channel_name,
        )
        for pos, _, stats in results:
            write_meta_field(pos, dataset_statistics | stats, "normalization", channel_name)


def generate_fg_masks(zarr_dir: str | Path, channel_names: list[str], fg_mask_key: str = "fg_mask") -> None:
    """Binary foreground masks (uint8) from the stored Otsu thresholds;
    channels without a threshold are all foreground."""
    plate = open_ome_zarr(zarr_dir, mode="r+")
    channel_indices = [plate.channel_names.index(n) for n in channel_names]
    for pos_name, pos in plate.positions():
        if fg_mask_key in pos:
            raise FileExistsError(f"Mask array {fg_mask_key!r} already exists at {pos_name}.")
        img = pos["0"]
        t_total, c_total = img.shape[:2]
        zyx = img.shape[2:]
        mask = pos.create_zeros(
            fg_mask_key,
            shape=(t_total, c_total, *zyx),
            dtype=np.uint8,
            chunks=(1, 1, zyx[0], min(zyx[1], 512), min(zyx[2], 512)),
        )
        for c in sorted(set(range(c_total)) - set(channel_indices)):
            mask[:, c] = np.ones((t_total, *zyx), np.uint8)
        for ch_name, ch_idx in zip(channel_names, channel_indices):
            thr = pos.zattrs["normalization"][ch_name]["fov_statistics"]["otsu_threshold"]
            for t in range(t_total):
                smoothed = median_filter(img[t, ch_idx].astype(np.float32), size=(1, 3, 3))
                mask[t, ch_idx] = (smoothed >= thr).astype(np.uint8)
