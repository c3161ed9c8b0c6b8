"""Whole-cell instance segmentation from the membrane channel: nucleus
seeds and a membrane watershed (counterpart of
``viscy_tpu/apps/dynacell/eval/segmentation_whole_cell.py``; reference
``evaluation/segmentation_whole_cell.py``), bit-identical to JAX's.

1. robust-clip both channels to [0, 1];
2. a solid cell mask: grey closing of ``clip(membrane + nucleus)`` in each
   XY plane, the lower multi-Otsu threshold, holes filled;
3. less the membrane walls: the upper multi-Otsu class of the blurred
   membrane, small specks removed;
4. plus the nucleus seeds' footprint, so that every nucleus is inside;
5. a marker watershed of the negative distance transform from the nucleus
   labels (their ids kept);
6. cells below the size floor dropped, labels made sequential;
7. the nucleus footprint carved out: the cytoplasmic shell is scored.

Sizes are in micrometres, turned to pixels by the lateral voxel size.

On a CUDA ``device`` the closing, the Gaussian and the distance transform
run there through :mod:`._ndimage` (scipy's bits); the percentiles, the
multi-Otsu thresholds, the labellings and the watershed stay numpy and
scipy on the host. Without a device (or on the CPU) it is scipy
throughout.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from viscy_tpu_torch.apps.dynacell.eval import _ndimage as nd
from viscy_tpu_torch.apps.dynacell.eval.segmentation import multi_otsu_thresholds, watershed

__all__ = ["segment_whole_cell", "slice_index", "CELL_DEFAULTS"]

CELL_DEFAULTS = dict(
    close_um=2.5,  # grayscale-closing radius bridging dim cytoplasm
    wall_sigma_um=0.35,  # membrane blur before wall thresholding
    wall_min_um=1.0,  # drop wall specks below this size
    hole_um=3.0,  # fill mask holes below this size
    min_cell_um=15.0,  # drop whole cells below this area/volume
)


def slice_index(memb_vol: np.ndarray, *, selection: str = "frac", fraction: float = 0.30) -> int:
    """A representative z-plane: at a fraction of the depth, or the sharpest
    (the largest variance)."""
    z = memb_vol.shape[0]
    if selection == "frac":
        return int(round(fraction * (z - 1)))
    if selection == "sharpest":
        return int(np.argmax(memb_vol.reshape(z, -1).var(axis=1)))
    raise ValueError(f"Unknown slice_selection: {selection!r}")


def _robust_clip(x: np.ndarray, p_lo: float = 1.0, p_hi: float = 99.5) -> np.ndarray:
    lo, hi = np.percentile(x, (p_lo, p_hi))
    return np.clip((x - lo) / max(hi - lo, 1e-8), 0.0, 1.0).astype(np.float32)


def _relabel_sequential(labels: np.ndarray) -> np.ndarray:
    ids = np.unique(labels)
    ids = ids[ids > 0]
    out = np.zeros(labels.shape, np.uint16)
    if ids.size == 0:
        return out
    remap = np.zeros(int(ids.max()) + 1, np.uint16)
    remap[ids] = np.arange(1, ids.size + 1, dtype=np.uint16)
    return remap[labels]


def _remove_small(mask: np.ndarray, min_px: int) -> np.ndarray:
    if min_px <= 1:
        return mask
    labels, n = ndimage.label(mask)
    if n == 0:
        return mask
    sizes = np.bincount(labels.ravel())
    keep = sizes >= min_px
    keep[0] = False
    return keep[labels]


def _fill_small_holes(mask: np.ndarray, max_px: int, fill_holes) -> np.ndarray:
    holes = fill_holes(mask) & ~mask
    small = _remove_small(holes, max_px + 1) ^ holes  # holes smaller than max_px
    return mask | small


def segment_whole_cell(memb_img: np.ndarray, nuc_img: np.ndarray, nucleus_labels: np.ndarray,
                       spacing_zyx=(1.0, 0.3, 0.3), *, close_um: float = CELL_DEFAULTS["close_um"],
                       wall_sigma_um: float = CELL_DEFAULTS["wall_sigma_um"],
                       wall_min_um: float = CELL_DEFAULTS["wall_min_um"], hole_um: float = CELL_DEFAULTS["hole_um"],
                       min_cell_um: float = CELL_DEFAULTS["min_cell_um"], carve_nucleus: bool = True,
                       device=None) -> np.ndarray:
    """Cytoplasm-only whole-cell instance labels (int32) from the membrane
    and nucleus channels of a ``(Z, Y, X)`` volume or a ``(Y, X)`` slice;
    ``nucleus_labels`` are the watershed's seeds, their ids kept. On a CUDA
    ``device`` the filters and the distance transform run there (the same
    labels)."""
    memb = np.asarray(memb_img, np.float32)
    nuc = np.asarray(nuc_img, np.float32)
    seeds = np.asarray(nucleus_labels, np.int32)
    if memb.shape != nuc.shape or memb.shape != seeds.shape:
        raise ValueError(f"shape mismatch: memb {memb.shape}, nuc {nuc.shape}, seeds {seeds.shape}")
    card = nd.on_card(device)
    is3d = memb.ndim == 3
    lateral_um = float(spacing_zyx[-1])
    px = lambda um: max(1, int(round(um / lateral_um)))  # noqa: E731
    area_px = lambda um: max(1, int(round(um / lateral_um**2)))  # noqa: E731
    fill_holes = nd.binary_fill_holes if card else ndimage.binary_fill_holes

    memb_n = _robust_clip(memb)
    combined = np.clip(memb_n + _robust_clip(nuc), 0.0, 1.0)

    # a flat grey closing in each XY plane bridges dim cytoplasm between the walls
    size = 2 * px(close_um) + 1
    if card:
        plane_axes = (1, 2) if is3d else (0, 1)
        dilated = nd.maximum_filter(torch.as_tensor(combined, device=device), size, plane_axes)
        closed = nd.minimum_filter(dilated, size, plane_axes).cpu().numpy()
        del dilated
    elif is3d:
        closed = np.stack([ndimage.grey_closing(combined[z], size=(size, size)) for z in range(combined.shape[0])])
    else:
        closed = ndimage.grey_closing(combined, size=(size, size))

    t_lo, _ = multi_otsu_thresholds(closed)
    tissue = _fill_small_holes(fill_holes(closed > t_lo), area_px(hole_um), fill_holes)

    # the membrane walls: the upper multi-Otsu class of the blurred membrane
    sigma = wall_sigma_um / lateral_um
    if card:
        memb_blur = nd.gaussian_filter(torch.as_tensor(memb_n, device=device), sigma).cpu().numpy()
    else:
        memb_blur = ndimage.gaussian_filter(memb_n, sigma)
    _, t_hi = multi_otsu_thresholds(memb_blur)
    walls = _remove_small(memb_blur > t_hi, area_px(wall_min_um))

    cell_mask = (tissue & ~walls) | (seeds > 0)
    edt = nd.distance_transform_edt(cell_mask, device) if card else ndimage.distance_transform_edt(cell_mask)
    cells = watershed(-edt, seeds, mask=cell_mask, device=device)

    # small cells dropped, by voxel count against the physical floor
    min_px = area_px(min_cell_um) if not is3d else max(1, int(round(min_cell_um / lateral_um**3)))
    sizes = np.bincount(cells.ravel())
    small_ids = np.flatnonzero(sizes < min_px)
    if small_ids.size:
        cells[np.isin(cells, small_ids[small_ids > 0])] = 0
    if carve_nucleus:
        cells = cells.copy()
        cells[seeds > 0] = 0
    return _relabel_sequential(cells).astype(np.int32)
