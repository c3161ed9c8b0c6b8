"""A seeded Cell Tracking Challenge sequence for the tracking benchmark's
tests and chip runs (no dataset has to be fetched).

Nuclei start on a jittered grid and take a random walk of a few pixels a
frame. At a division the parent's disk is cut in two halves through its
centre, each a daughter track (``parent_track`` the parent), and the
daughters then drift apart as disks of half the parent's area. The raw
frame is a Gaussian blob a nucleus over a noisy background (uint16), the
GT masks label each nucleus by its track id, and the error segmentation
relabels each frame at random, drops one detection in ``drops`` frames and
merges the two nearest nuclei into one detection in ``merges`` frames.
Everything is written in the CTC layout through the port's TIFF writer:
``{seq}/tNNN.tif``, ``{seq}_ERR_SEG/maskNNN.tif`` and
``{seq}_GT/TRA/{man_track.txt, man_trackNNN.tif}``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from viscy_tpu_torch.data.tiff import write_tiff

__all__ = ["ctc_sequence"]


def ctc_sequence(root: str | Path, sequence: str = "01", frames: int = 40, side: int = 1024, cells: int = 30,
                 radius: float = 18.0, divisions: int = 3, drops: int = 4, merges: int = 3,
                 seed: int = 0) -> dict[str, np.ndarray]:
    """Write the sequence under ``root`` and return its ``raw``, ``seg``
    and ``gt`` stacks (T, side, side) and the ``tracks`` table (rows of
    ``track_id, t_start, t_end, parent_track``)."""
    rng = np.random.default_rng(seed)
    grid = int(np.ceil(np.sqrt(cells)))
    step = side / grid
    gy, gx = np.divmod(rng.permutation(grid * grid)[:cells], grid)
    jitter = rng.uniform(-step / 8, step / 8, (cells, 2))
    tracks = {i + 1: dict(y=(gy[i] + 0.5) * step + jitter[i, 0], x=(gx[i] + 0.5) * step + jitter[i, 1], r=radius,
                          t0=0, parent=0, v=(0.0, 0.0), cut=None) for i in range(cells)}
    div_at = dict(zip(rng.choice(np.arange(3, frames - 2), divisions, replace=False).tolist(),
                      rng.choice(sorted(tracks), divisions, replace=False).tolist()))
    alive, ends = set(tracks), {}
    half = int(np.ceil(2.5 * radius))
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1]
    gt = np.zeros((frames, side, side), np.uint16)
    raw = np.zeros((frames, side, side), np.float32)
    for t in range(frames):
        if t in div_at:
            p = tracks[div_at[t]]
            alive.discard(div_at[t])
            ends[div_at[t]] = t - 1
            ang = rng.uniform(0, np.pi)
            for s in (-1, 1):
                tid = max(tracks) + 1
                # this frame: the half of the parent's disk on side s of the cut
                tracks[tid] = dict(y=p["y"], x=p["x"], r=p["r"], t0=t, parent=div_at[t],
                                   v=(s * 1.5 * np.sin(ang), s * 1.5 * np.cos(ang)), cut=(s, ang))
                alive.add(tid)
        for tid in sorted(alive):
            c = tracks[tid]
            if t > c["t0"]:
                if c["cut"] is not None:  # the frame after the division: a disk at the half's centroid
                    s, ang = c["cut"]
                    shift = 4 * c["r"] / (3 * np.pi)
                    c.update(y=c["y"] + s * shift * np.sin(ang), x=c["x"] + s * shift * np.cos(ang),
                             r=c["r"] / np.sqrt(2), cut=None)
                c["y"] = float(np.clip(c["y"] + c["v"][0] + rng.normal(0, 2.0), half, side - half - 1))
                c["x"] = float(np.clip(c["x"] + c["v"][1] + rng.normal(0, 2.0), half, side - half - 1))
            iy, ix = int(round(c["y"])), int(round(c["x"]))
            dy, dx = yy + iy - c["y"], xx + ix - c["x"]
            d2 = dy * dy + dx * dx
            inside = d2 <= c["r"] ** 2
            if c["cut"] is not None:
                s, ang = c["cut"]
                inside &= s * (dy * np.sin(ang) + dx * np.cos(ang)) >= 0
            win = (slice(iy - half, iy + half + 1), slice(ix - half, ix + half + 1))
            frame = gt[t][win]
            frame[inside & (frame == 0)] = tid
            raw[t][win] += np.float32(1500 + 25 * (tid % 7)) * np.exp(-d2 / (2 * (0.6 * c["r"]) ** 2))
    raw = np.clip(raw + rng.normal(200, 20, raw.shape), 0, 65535).astype(np.uint16)
    seg = np.zeros_like(gt)
    drop_at = set(rng.choice(np.arange(1, frames), drops, replace=False).tolist())
    merge_at = set(rng.choice(np.arange(1, frames), merges, replace=False).tolist())
    for t in range(frames):
        ids = np.flatnonzero(np.bincount(gt[t].ravel()))[1:]
        relabel = np.zeros(int(ids.max()) + 1, np.uint16)
        relabel[ids] = rng.permutation(len(ids)) + 1
        seg[t] = relabel[gt[t]]
        if t in drop_at:
            seg[t][seg[t] == 1] = 0
        if t in merge_at:  # the two nearest nuclei become one detection
            pos = np.asarray([(tracks[i]["y"], tracks[i]["x"]) for i in ids])
            d = np.hypot(*(pos[:, None] - pos[None]).transpose(2, 0, 1)) + np.eye(len(ids)) * 1e9
            a, b = np.unravel_index(np.argmin(d), d.shape)
            seg[t][seg[t] == relabel[ids[b]]] = relabel[ids[a]]
    table = np.asarray([[tid, c["t0"], ends.get(tid, frames - 1), c["parent"]] for tid, c in sorted(tracks.items())])
    root = Path(root)
    for sub in (sequence, f"{sequence}_ERR_SEG", f"{sequence}_GT/TRA"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for t in range(frames):
        write_tiff(root / sequence / f"t{t:03d}.tif", raw[t])
        write_tiff(root / f"{sequence}_ERR_SEG" / f"mask{t:03d}.tif", seg[t])
        write_tiff(root / f"{sequence}_GT" / "TRA" / f"man_track{t:03d}.tif", gt[t])
    np.savetxt(root / f"{sequence}_GT" / "TRA" / "man_track.txt", table, fmt="%d")
    return {"raw": raw, "seg": seg, "gt": gt, "tracks": table}
