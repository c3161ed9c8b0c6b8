"""Template persistence for the pseudotime pipeline (counterpart of
``viscy_tpu/apps/dynaclr/pseudotime/io.py``): templates as zarr groups, one
"flavor" subgroup per template variant carrying the template rows, the
z-score parameters, the PCA, the label-propagation fractions, the
real-time calibration and the tau event band, through the uncompressed
zarr primitives of :mod:`viscy_tpu_torch.evaluation.anndata_lite`. The
layout is JAX's, so stores cross both ways; a loaded PCA is the port's
:class:`~viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_alignment.PCAProjection`.
"""

from __future__ import annotations

import glob
import json
import logging
import re
import subprocess
from pathlib import Path

import numpy as np

from viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_alignment import PCAProjection, TemplateResult
from viscy_tpu_torch.evaluation.anndata_lite import _init_group, _read_array, _write_array

_logger = logging.getLogger("viscy_tpu_torch")

__all__ = ["compute_tau_event_band", "date_prefix_from_dataset_id", "find_embedding_zarr", "get_dynaclr_versions",
           "load_template_flavor", "read_tau_event_band", "read_template_attrs", "read_time_calibration",
           "save_template_zarr"]


def date_prefix_from_dataset_id(dataset_id: str) -> str:
    """Leading date token of a dataset id (``2024_07_24_A549`` -> ``07_24``)."""
    m = re.search(r"(\d{2})_(\d{2})", dataset_id)
    return f"{m.group(1)}_{m.group(2)}" if m else dataset_id


def compute_tau_event_band(time_calibration: np.ndarray,
                           band_minutes: tuple[float, float] = (-60.0, 60.0)) -> tuple[float, float]:
    """The normalized pseudotime band in [0, 1] covering ``band_minutes`` of
    real time around the anchored event (calibration minute 0)."""
    tc = np.asarray(time_calibration, float)
    if len(tc) < 2:
        return 0.0, 1.0
    pos = np.arange(len(tc)) / (len(tc) - 1)
    return float(np.interp(band_minutes[0], tc, pos)), float(np.interp(band_minutes[1], tc, pos))


def save_template_zarr(template_path: str | Path, result: TemplateResult, flavor: str = "default",
                       attrs: dict | None = None, tau_band_minutes: tuple[float, float] = (-60.0, 60.0)) -> Path:
    """Write one template flavor into a zarr group store (arrays float32)."""
    template_path = Path(template_path)
    _init_group(template_path, {"store": "dynaclr-pseudotime-template", **(attrs or {})})
    grp = template_path / flavor
    flavor_attrs = {"template_id": result.template_id, "n_input_tracks": result.n_input_tracks,
                    "explained_variance": result.explained_variance,
                    "template_cell_ids": [list(c) for c in result.template_cell_ids]}
    if result.time_calibration is not None:
        flavor_attrs["tau_event_band"] = list(compute_tau_event_band(result.time_calibration, tau_band_minutes))
    _init_group(grp, flavor_attrs)
    _write_array(grp / "template", np.asarray(result.template, np.float32))
    if result.time_calibration is not None:
        _write_array(grp / "time_calibration", np.asarray(result.time_calibration, np.float32))
    zs = grp / "zscore_params"
    _init_group(zs, {"datasets": sorted(result.zscore_params)})
    for dataset_id, (mean, std) in result.zscore_params.items():
        _write_array(zs / f"{dataset_id}__mean", np.asarray(mean, np.float32))
        _write_array(zs / f"{dataset_id}__std", np.asarray(std, np.float32))
    if result.pca is not None:
        pca_grp = grp / "pca"
        _init_group(pca_grp, {"n_components": int(result.pca.n_components_)})
        _write_array(pca_grp / "components", np.asarray(result.pca.components_, np.float32))
        _write_array(pca_grp / "mean", np.asarray(result.pca.mean_, np.float32))
        _write_array(pca_grp / "explained_variance", np.asarray(result.pca.explained_variance_, np.float32))
    if result.template_labels:
        lab = grp / "labels"
        _init_group(lab, {"columns": sorted(result.template_labels)})
        for col, classes in result.template_labels.items():
            _init_group(lab / col, {"classes": sorted(classes)})
            for cls, arr in classes.items():
                _write_array(lab / col / str(cls), np.asarray(arr, np.float32))
    _logger.info("saved template flavor %r to %s", flavor, template_path)
    return template_path


def _read_attrs(path: Path) -> dict:
    f = path / ".zattrs"
    return json.loads(f.read_text()) if f.exists() else {}


def load_template_flavor(template_path: str | Path, flavor: str = "default") -> tuple[TemplateResult, dict]:
    """One template flavor and its attributes; the PCA comes back as a
    :class:`PCAProjection` (components and mean, enough to project)."""
    template_path = Path(template_path)
    grp = template_path / flavor
    if not grp.exists():
        available = [p.name for p in template_path.iterdir() if p.is_dir()]
        raise FileNotFoundError(f"flavor {flavor!r} not in {template_path} (available: {available})")
    attrs = _read_attrs(grp)
    tc = _read_array(grp / "time_calibration") if (grp / "time_calibration").exists() else None
    zparams = {}
    if (grp / "zscore_params").exists():
        for mean_path in (grp / "zscore_params").glob("*__mean"):
            dataset_id = mean_path.name[: -len("__mean")]
            zparams[dataset_id] = (_read_array(mean_path), _read_array(grp / "zscore_params" / f"{dataset_id}__std"))
    pca = None
    if (grp / "pca").exists():
        ev_path = grp / "pca" / "explained_variance"
        pca = PCAProjection(_read_array(grp / "pca" / "components"), _read_array(grp / "pca" / "mean"),
                            _read_array(ev_path) if ev_path.exists() else None)
    labels = None
    if (grp / "labels").exists():
        labels = {col.name: {cls.name: _read_array(cls) for cls in col.iterdir() if cls.is_dir()}
                  for col in (grp / "labels").iterdir() if col.is_dir()}
    result = TemplateResult(template=_read_array(grp / "template"), template_id=attrs.get("template_id", flavor),
                            pca=pca, zscore_params=zparams,
                            template_cell_ids=[tuple(c) for c in attrs.get("template_cell_ids", [])],
                            n_input_tracks=int(attrs.get("n_input_tracks", 0)),
                            explained_variance=attrs.get("explained_variance"), template_labels=labels,
                            time_calibration=tc)
    return result, attrs


def read_template_attrs(template_path: str | Path) -> dict:
    return _read_attrs(Path(template_path))


def read_time_calibration(template_path: str | Path, flavor: str = "default") -> np.ndarray:
    return _read_array(Path(template_path) / flavor / "time_calibration")


def read_tau_event_band(template_path: str | Path, flavor: str = "default") -> tuple[float, float]:
    band = _read_attrs(Path(template_path) / flavor).get("tau_event_band")
    if band is None:
        raise KeyError(f"flavor {flavor!r} has no tau_event_band (no time calibration at save time)")
    return float(band[0]), float(band[1])


def find_embedding_zarr(pred_dir: str | Path, pattern: str) -> str:
    """The single embedding store matching ``pattern`` in ``pred_dir``; a
    pattern ending in ``"_*.zarr"`` is retried without the underscore; none
    or several raise ``FileNotFoundError``."""
    matches = glob.glob(str(Path(pred_dir) / pattern))
    if not matches and pattern.endswith("_*.zarr"):
        matches = glob.glob(str(Path(pred_dir) / (pattern[: -len("_*.zarr")] + "*.zarr")))
    if not matches:
        raise FileNotFoundError(f"No zarr matching {pattern} in {pred_dir}")
    if len(matches) > 1:
        raise FileNotFoundError(f"Multiple zarrs match {pattern}: {sorted(Path(m).name for m in matches)}")
    return matches[0]


def get_dynaclr_versions() -> dict[str, str]:
    """Code and library versions stamped into template stores: the git
    commit, torch and numpy, and the DTW kernel's source."""
    import torch

    sha = "unknown"
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
                             cwd=Path(__file__).parent, timeout=10)
        if out.returncode == 0:
            sha = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"viscy_tpu_git_sha": sha, "torch_version": torch.__version__, "numpy_version": np.__version__,
            "dtw_kernel": "viscy_tpu_torch/csrc/dtw.cpp (host, g++)"}
