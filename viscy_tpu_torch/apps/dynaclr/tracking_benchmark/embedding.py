"""Cell-crop embeddings for tracking edges (counterpart of
``viscy_tpu/apps/dynaclr/tracking_benchmark/embedding.py``).

Crops are cut on the host with JAX's numpy arithmetic (so they are bit for
bit JAX's): centred on each node, reflect-padded at the borders, resized
by JAX's bilinear rule where the pixel sizes differ, z-scored with the
whole frame's statistics. They are embedded by any batched callable: in
production :func:`make_torch_embedder`'s eval-mode encoder forward on the
card, each batch moved to the device once. JAX zero-pads the last batch to
a static shape for XLA; the port hands the encoder the short batch (in
eval mode the padding changes nothing).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.graph import CandidateGraph
from viscy_tpu_torch.device import resolve_device

__all__ = [
    "pad_to_shape",
    "normalize_crop",
    "crop_node",
    "node_crops",
    "embed_crops",
    "compute_node_embeddings",
    "add_embedding_similarity",
    "make_torch_embedder",
]


def pad_to_shape(image: np.ndarray, shape: tuple[int, int], mode: str = "reflect") -> np.ndarray:
    """Pad symmetrically to at least ``shape`` (unchanged when large enough)."""
    diff = np.maximum(np.asarray(shape) - np.asarray(image.shape), 0)
    if diff.sum() == 0:
        return image
    left = diff // 2
    right = diff - left
    return np.pad(image, tuple(zip(left, right)), mode=mode)


def normalize_crop(crop: np.ndarray, frame_mean: float, frame_std: float) -> np.ndarray:
    """Z-score with the whole frame's statistics (training's normalization)."""
    return (crop - frame_mean) / max(frame_std, 1e-8)


def _resize_bilinear(img: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """JAX's bilinear resize (half-pixel centres, edges clamped)."""
    h, w = img.shape
    th, tw = shape
    if (h, w) == (th, tw):
        return img
    ys = (np.arange(th) + 0.5) * h / th - 0.5
    xs = (np.arange(tw) + 0.5) * w / tw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(img.dtype)


def crop_node(frame: np.ndarray, center: tuple[float, ...], source_shape: tuple[int, int],
              final_shape: tuple[int, int], frame_mean: float, frame_std: float) -> np.ndarray:
    """One cell's crop: ``source_shape`` pixels centred on the cell,
    reflect-padded, resized to ``final_shape`` when they differ, z-scored."""
    if frame.ndim == 3:  # a single-z 3-D frame
        if frame.shape[0] != 1:
            raise ValueError(f"expected 1 z-slice, got {frame.shape[0]}")
        frame = frame[0]
        center = center[-2:]
    cy, cx = int(round(center[-2])), int(round(center[-1]))
    hh, hw = source_shape[0] // 2, source_shape[1] // 2
    y0, y1 = max(0, cy - hh), min(frame.shape[0], cy - hh + source_shape[0])
    x0, x1 = max(0, cx - hw), min(frame.shape[1], cx - hw + source_shape[1])
    crop = frame[y0:y1, x0:x1].astype(np.float32)
    crop = pad_to_shape(crop, source_shape, mode="reflect")
    if tuple(source_shape) != tuple(final_shape):
        crop = _resize_bilinear(crop, final_shape)
    return normalize_crop(crop, frame_mean, frame_std)


def node_crops(graph: CandidateGraph, images: np.ndarray, model_input_shape: tuple[int, int] = (160, 160),
               pixel_size_scale: float = 1.0) -> np.ndarray:
    """Every node's crop, (n_nodes, H, W) float32, in node order."""
    source_shape = (round(model_input_shape[0] * pixel_size_scale), round(model_input_shape[1] * pixel_size_scale))
    nodes = graph.nodes
    pos_cols = ["z", "y", "x"] if "z" in nodes else ["y", "x"]
    crops = np.empty((graph.num_nodes(), *model_input_shape), dtype=np.float32)
    frame_stats: dict[int, tuple[float, float]] = {}
    for i, t in enumerate(nodes["t"].tolist()):
        if t not in frame_stats:
            f = images[t].astype(np.float32)
            frame_stats[t] = (float(f.mean()), float(f.std()))
        mean, std = frame_stats[t]
        center = tuple(float(nodes[c][i]) for c in pos_cols)
        crops[i] = crop_node(images[t], center, source_shape, model_input_shape, mean, std)
    return crops


def embed_crops(crops: np.ndarray, embed_fn: Callable[[np.ndarray], np.ndarray], batch_size: int = 128) -> np.ndarray:
    """``embed_fn`` over ``(B, 1, 1, H, W)`` batches of the crops, the rows
    L2-normalized: (n, D)."""
    feats = [np.asarray(embed_fn(crops[s:s + batch_size][:, None, None, ...]))
             for s in range(0, len(crops), batch_size)]
    emb = np.concatenate(feats, axis=0)
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(norms, 1e-12)


def compute_node_embeddings(graph: CandidateGraph, images: np.ndarray, embed_fn: Callable[[np.ndarray], np.ndarray],
                            model_input_shape: tuple[int, int] = (160, 160), batch_size: int = 128,
                            pixel_size_scale: float = 1.0, seconds: dict | None = None) -> np.ndarray:
    """Embed every node's crop: (n_nodes, D), L2-normalized. ``embed_fn``
    maps a ``(B, 1, 1, H, W)`` float32 batch to ``(B, D)`` features.
    ``seconds``, when given, receives the wall seconds of the crops and of
    the embedding."""
    t0 = time.perf_counter()
    crops = node_crops(graph, images, model_input_shape, pixel_size_scale)
    t1 = time.perf_counter()
    emb = embed_crops(crops, embed_fn, batch_size)
    if seconds is not None:
        seconds.update(crops=t1 - t0, embedding=time.perf_counter() - t1)
    return emb


def add_embedding_similarity(graph: CandidateGraph, embeddings: np.ndarray, key: str = "dynaclr_similarity") -> None:
    """Each edge's cosine similarity of its nodes' normalized embeddings."""
    pos = {int(nid): i for i, nid in enumerate(graph.nodes["node_id"])}
    s = np.array([pos[int(v)] for v in graph.edges["source"]], dtype=int)
    t = np.array([pos[int(v)] for v in graph.edges["target"]], dtype=int)
    graph.edges[key] = np.einsum("nd,nd->n", embeddings[s], embeddings[t])


def make_torch_embedder(module: torch.nn.Module, device: str | torch.device = "cuda") -> Callable:
    """An eval-mode encoder as the ``embed_fn`` contract: a ``(B, 1, 1, H,
    W)`` numpy batch in, moved to ``device`` once; ``(B, D)`` float32 numpy
    features out (the first output of a model that returns several, the
    backbone features)."""
    dev = resolve_device(device)
    module = module.to(dev).eval()

    @torch.no_grad()
    def embed(batch: np.ndarray) -> np.ndarray:
        out = module(torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32)).to(dev))
        if isinstance(out, (tuple, list)):
            out = out[0]
        return out.float().cpu().numpy()

    return embed
