"""Image and embedding logging utilities (counterpart of
``viscy_tpu/training/log_images.py``), in numpy on the host."""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def detach_sample(arrays, n_samples: int = 1) -> list[list[np.ndarray]]:
    """The first ``n_samples`` samples of each (B, C, Z, Y, X) array (its
    center slice) or (B, C, Y, X) array, float32 on the host."""
    out = []
    for i in range(n_samples):
        row = []
        for arr in arrays:
            a = _host(arr)
            if a.ndim == 5:
                a = a[i, :, a.shape[2] // 2]
            elif a.ndim == 4:
                a = a[i]
            row.append(a.astype(np.float32))
        out.append(row)
    return out


def render_images(samples: list[list[np.ndarray]], cmaps=None) -> np.ndarray:
    """One (H, W, 3) grid: a row per sample, a cell per channel, each cell
    scaled from its 1st to its 99th percentile into [0, 1]."""
    rows = []
    for row in samples:
        cells = []
        for arr in row:
            for c in range(arr.shape[0]):
                img = arr[c]
                lo, hi = np.percentile(img, [1, 99])
                img = np.clip((img - lo) / max(hi - lo, 1e-6), 0, 1)
                cells.append(np.stack([img] * 3, axis=-1))
        h = max(c.shape[0] for c in cells)
        cells = [np.pad(c, ((0, h - c.shape[0]), (0, 0), (0, 0))) if c.shape[0] < h else c for c in cells]
        rows.append(np.concatenate(cells, axis=1))
    w = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0))) if r.shape[1] < w else r for r in rows]
    return np.concatenate(rows, axis=0)


def log_image_grid(logger, tag: str, samples: list[list[np.ndarray]], step: int) -> None:
    """Render ``samples`` and log the grid through the trainer's logger."""
    logger.log_image(tag, render_images(samples), step)


def pca_pairplot(features: np.ndarray, labels=None, n_components: int = 4) -> np.ndarray:
    """A scatter matrix of the first principal components, rendered to an
    (H, W, 3) uint8 array. The components are the embedding writer's PCA
    (a float64 SVD with sklearn's sign rule, on the host, where the
    snapshot's features are); the drawing needs matplotlib
    (an ``ImportError`` without it)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from viscy_tpu_torch.training.callbacks.embedding_writer import pca

    n = min(n_components, min(features.shape) - 1)
    pcs = pca(np.asarray(features, np.float64), n, device="cpu")
    fig, axes = plt.subplots(n - 1, n - 1, figsize=(2 * n, 2 * n), squeeze=False)
    for i in range(n - 1):
        for j in range(n - 1):
            ax = axes[i][j]
            if j > i:
                ax.axis("off")
                continue
            ax.scatter(pcs[:, j], pcs[:, i + 1], s=2, c=labels, cmap="tab10")
            ax.set_xticks([])
            ax.set_yticks([])
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img
