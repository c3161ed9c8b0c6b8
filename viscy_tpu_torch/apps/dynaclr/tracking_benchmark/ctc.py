"""Cell Tracking Challenge ground truth and results on disk (counterpart of
``viscy_tpu/apps/dynaclr/tracking_benchmark/ctc.py``).

CTC layout (celltrackingchallenge.net):

- ``{seq}_GT/TRA/man_track.txt``: lines ``track_id t_start t_end parent``;
- ``{seq}_GT/TRA/man_trackNNN.tif``: 16-bit label masks, label = track id;
- a result mirrors it as ``res_track.txt`` and ``maskNNN.tif``.

TIFFs go through the port's own codec (:mod:`viscy_tpu_torch.data.tiff`:
baseline, one grayscale page, uncompressed strips), since the card's
machine has neither imageio nor PIL; JAX reads them through imageio.
Track tables are column dicts ``track_id, t_start, t_end, parent_track``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from viscy_tpu_torch.data.tiff import read_tiff, write_tiff

__all__ = ["CTCGroundTruth", "load_ctc_ground_truth", "load_tiff_stack", "write_ctc_result", "seg_dir",
           "tracking_to_ctc"]

TRACK_COLUMNS = ("track_id", "t_start", "t_end", "parent_track")


def seg_dir(dataset_dir: Path, sequence: str) -> Path:
    """The error-segmentation directory of a sequence (``{seq}_ERR_SEG``)."""
    return Path(dataset_dir) / f"{sequence}_ERR_SEG"


def load_tiff_stack(directory: Path, pattern: str = "*.tif") -> np.ndarray:
    """A sorted TIFF sequence as a (T, ...) stack."""
    files = sorted(Path(directory).glob(pattern))
    if not files:
        raise FileNotFoundError(f"no {pattern} files in {directory}")
    return np.stack([read_tiff(f) for f in files], axis=0)


def track_table(table: np.ndarray) -> dict[str, np.ndarray]:
    table = np.asarray(table, dtype=np.int64).reshape(-1, 4)
    return {c: table[:, i] for i, c in enumerate(TRACK_COLUMNS)}


@dataclass
class CTCGroundTruth:
    """Label masks (``masks[t]`` labels pixels by track id) and the track
    table (parent 0: none)."""

    masks: np.ndarray
    tracks: dict[str, np.ndarray]

    def edges(self) -> dict[str, np.ndarray]:
        """Every temporal edge: consecutive frames of a track, and parent to
        child at a division; columns ``track_a, t_a, track_b, t_b,
        is_parent_link``."""
        rows = []
        present: dict[int, np.ndarray] = {}
        tids = [int(v) for v in self.tracks["track_id"]]
        for tid, t0, t1 in zip(tids, self.tracks["t_start"], self.tracks["t_end"]):
            ts = np.array([t for t in range(int(t0), int(t1) + 1)
                           if t < len(self.masks) and (self.masks[t] == tid).any()])
            present[tid] = ts
            rows += [(tid, int(a), tid, int(b), False) for a, b in zip(ts[:-1], ts[1:])]
        for tid, parent in zip(tids, self.tracks["parent_track"]):
            parent = int(parent)
            if parent > 0 and len(present.get(parent, ())) and len(present[tid]):
                rows.append((parent, int(present[parent][-1]), tid, int(present[tid][0]), True))
        names = ("track_a", "t_a", "track_b", "t_b", "is_parent_link")
        return {k: np.asarray([r[i] for r in rows], dtype=bool if k == "is_parent_link" else np.int64)
                for i, k in enumerate(names)}


def load_ctc_ground_truth(tra_dir: Path) -> CTCGroundTruth:
    """A CTC ``TRA`` (or ``RES``) directory."""
    tra_dir = Path(tra_dir)
    track_file = next((tra_dir / n for n in ("man_track.txt", "res_track.txt") if (tra_dir / n).exists()), None)
    if track_file is None:
        raise FileNotFoundError(f"no man_track.txt/res_track.txt in {tra_dir}")
    return CTCGroundTruth(masks=load_tiff_stack(tra_dir, "*.tif"),
                          tracks=track_table(np.atleast_2d(np.loadtxt(track_file, dtype=int))))


def write_ctc_result(out_dir: Path, masks: np.ndarray, tracks: dict[str, np.ndarray]) -> None:
    """A tracking result in the CTC ``RES`` layout: ``res_track.txt`` and
    one uint16 ``maskNNN.tif`` a frame."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savetxt(out_dir / "res_track.txt", np.stack([np.asarray(tracks[c], int) for c in TRACK_COLUMNS], axis=1)
               .reshape(-1, 4), fmt="%d")
    width = max(3, len(str(len(masks) - 1)))
    for t in range(len(masks)):
        write_tiff(out_dir / f"mask{t:0{width}d}.tif", masks[t].astype(np.uint16))


def tracking_to_ctc(solution, node_pixels: dict[int, np.ndarray], frame_shape: tuple[int, ...],
                    n_frames: int) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """A solved :class:`~.graph.TrackingGraph` as CTC masks and track
    table."""
    masks = np.zeros((n_frames, *frame_shape), dtype=np.uint16)
    for nid, t, tid in zip(solution.nodes["node_id"], solution.nodes["t"], solution.nodes["track_id"]):
        if tid <= 0:
            continue
        frame = masks[int(t)].ravel()
        frame[node_pixels[int(nid)]] = tid
    return masks, solution.tracks
