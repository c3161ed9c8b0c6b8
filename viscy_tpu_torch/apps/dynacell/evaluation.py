"""Plate-against-plate evaluation with per-FOV result caching (counterpart
of ``viscy_tpu/apps/dynacell/evaluation.py``; reference
``evaluation/{pipeline.py,cache.py}``):

1. pixel: Pearson, SSIM (a 21 x 21 uniform window, the depth window the
   whole stack), MAE, MSE, on the device;
2. instance: POD (IoU-matched instance detection) over label channels, on
   the host.

:func:`evaluate_plates` returns the tidy rows (``fov``, ``t``,
``channel``, ``metric``, ``value``) as a list of dicts in JAX's order, or
writes them as CSV, where JAX returns a DataFrame: the card's machine has
no pandas.
"""

from __future__ import annotations

import csv
import hashlib
import json
import logging
from pathlib import Path

import numpy as np
import torch

from viscy_tpu_torch.apps.dynacell.eval._ops import on, resolve_device
from viscy_tpu_torch.evaluation.metrics import pod_metric
from viscy_tpu_torch.ops.ssim import ssim_25d
from viscy_tpu_torch.zarr_io.store import open_ome_zarr

_logger = logging.getLogger(__name__)

__all__ = ["EvaluationCache", "evaluate_plates", "pixel_metrics"]

COLUMNS = ("fov", "t", "channel", "metric", "value")


class EvaluationCache:
    """Per-(fov, t, metric set) results as JSON files named by a hash of
    their key (JAX's files: either package reads the other's)."""

    def __init__(self, cache_dir: str | Path) -> None:
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _key(self, **kwargs) -> str:
        payload = json.dumps(kwargs, sort_keys=True, default=str)
        return hashlib.sha1(payload.encode()).hexdigest()[:20]

    def get(self, **kwargs) -> dict | None:
        path = self.cache_dir / f"{self._key(**kwargs)}.json"
        if path.exists():
            return json.loads(path.read_text())
        return None

    def put(self, result: dict, **kwargs) -> None:
        path = self.cache_dir / f"{self._key(**kwargs)}.json"
        path.write_text(json.dumps(result, default=float))


def pixel_metrics(pred, target, device="cuda") -> dict:
    """Pixel metrics of (C, Z, Y, X) volumes on ``device``: Pearson, MAE and
    MSE in float64, and the 2.5-D SSIM (:func:`ssim_25d`, float32, window
    (21, 21), the depth window the whole stack), left out when the volume
    is smaller than the window."""
    dev = resolve_device(device)
    p, t = on(pred, dev), on(target, dev)
    pc, tc = p.reshape(-1) - p.mean(), t.reshape(-1) - t.mean()
    denom = float(torch.linalg.vector_norm(pc)) * float(torch.linalg.vector_norm(tc))
    d = p - t
    out = {
        "pearson": float(torch.dot(pc, tc)) / denom if denom > 0 else 0.0,
        "mae": float(d.abs().mean()),
        "mse": float((d * d).mean()),
    }
    if all(n >= 21 for n in p.shape[-2:]):
        out["ssim"] = float(ssim_25d(p.float()[None], t.float()[None], (21, 21)).mean())
    else:
        _logger.debug("ssim skipped: the volume %s is smaller than the (21, 21) window", tuple(p.shape))
    return out


def _cached(cache: EvaluationCache | None, key: dict, compute) -> dict:
    result = cache.get(**key) if cache else None
    if result is None:
        result = compute()
        if cache:
            cache.put(result, **key)
    return result


def evaluate_plates(pred_path: str | Path, target_path: str | Path, channel_pairs: list[tuple[str, str]],
                    cache_dir: str | Path | None = None, instance_label_pairs: list[tuple[str, str]] | None = None,
                    csv_path: str | Path | None = None, device="cuda") -> list[dict]:
    """A prediction plate against a target plate, FOV by FOV and timepoint
    by timepoint: the pixel metrics of each ``(pred channel, target
    channel)`` pair and the POD of each integer-label pair (on the mid-Z
    slice), reused from ``cache_dir`` where it has them. Returns the tidy
    rows; with ``csv_path`` also writes them there."""
    dev = resolve_device(device)
    pred_plate = open_ome_zarr(pred_path)
    target_plate = open_ome_zarr(target_path)
    cache = EvaluationCache(cache_dir) if cache_dir else None
    target_by_name = dict(target_plate.positions())
    rows = []
    for name, pred_pos in pred_plate.positions():
        if name not in target_by_name:
            _logger.warning(f"FOV {name} missing from target plate")
            continue
        target_pos = target_by_name[name]
        t_total = min(pred_pos["0"].frames, target_pos["0"].frames)

        def read(t: int, pred_ch: str, target_ch: str) -> tuple[np.ndarray, np.ndarray]:
            return (pred_pos["0"][t, pred_pos.get_channel_index(pred_ch)],
                    target_pos["0"][t, target_pos.get_channel_index(target_ch)])

        for t in range(t_total):
            base = dict(fov=name, t=t, pred=str(pred_path), target=str(target_path))
            for pred_ch, target_ch in channel_pairs:
                def pixel():
                    p, g = read(t, pred_ch, target_ch)
                    return pixel_metrics(p[None], g[None], device=dev)

                result = _cached(cache, dict(base, pc=pred_ch, tc=target_ch, kind="pixel"), pixel)
                rows += [dict(fov=name, t=t, channel=pred_ch, metric=k, value=v) for k, v in result.items()]
            for pred_ch, target_ch in instance_label_pairs or []:
                def instance():
                    p, g = read(t, pred_ch, target_ch)
                    z = p.shape[0] // 2
                    return pod_metric(p[z].astype(np.int32), g[z].astype(np.int32))

                result = _cached(cache, dict(base, pc=pred_ch, tc=target_ch, kind="instance"), instance)
                rows += [dict(fov=name, t=t, channel=pred_ch, metric=f"pod_{k}", value=v) for k, v in result.items()]
    if csv_path is not None:
        with open(csv_path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(COLUMNS)
            writer.writerows([r[c] for c in COLUMNS] for r in rows)
    return rows
