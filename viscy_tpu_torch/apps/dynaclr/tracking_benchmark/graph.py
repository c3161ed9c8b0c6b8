"""Candidate graphs for tracking (counterpart of
``viscy_tpu/apps/dynaclr/tracking_benchmark/graph.py``).

Nodes come from each frame's labels; candidate edges link each node to its
nearest nodes within a distance in each of the ``delta_t`` frames before
it (``scipy.spatial.cKDTree``). Nodes and edges are column dicts of numpy
arrays, with JAX's columns in JAX's order and JAX's ``node_id``\\ s: nodes
``node_id, t, label, area, y, x`` (``z`` last for 3-D labels), edges
``source, target, dist, delta_t`` and the attributes added later
(``iou``, ``dynaclr_similarity``, ``weight``); ``source`` is the earlier
node.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["CandidateGraph", "TrackingGraph", "extract_nodes", "build_candidate_graph", "add_iou_attr", "take"]

NODE_COLUMNS = ("node_id", "t", "label", "area", "y", "x")


def take(columns: dict[str, np.ndarray], rows) -> dict[str, np.ndarray]:
    """The rows at ``rows`` (indices or a boolean mask) of every column."""
    return {k: v[rows] for k, v in columns.items()}


def _empty_edges() -> dict[str, np.ndarray]:
    return {"source": np.zeros(0, np.int64), "target": np.zeros(0, np.int64), "dist": np.zeros(0),
            "delta_t": np.zeros(0, np.int64)}


@dataclass
class CandidateGraph:
    """Nodes and candidate edges before solving, with each node's flat
    pixel indices into its frame (for mask attributes)."""

    nodes: dict[str, np.ndarray]
    edges: dict[str, np.ndarray]
    node_pixels: dict[int, np.ndarray] = field(default_factory=dict)
    frame_shape: tuple[int, ...] = ()

    def num_nodes(self) -> int:
        return len(self.nodes["node_id"])

    def num_edges(self) -> int:
        return len(self.edges["source"])


@dataclass
class TrackingGraph:
    """A solved tracking: the selected nodes (with ``track_id``), the
    linking edges and the CTC track table ``track_id, t_start, t_end,
    parent_track`` (0: no parent)."""

    nodes: dict[str, np.ndarray]
    edges: dict[str, np.ndarray]
    tracks: dict[str, np.ndarray]


def extract_nodes(labels: np.ndarray) -> tuple[dict[str, np.ndarray], dict[int, np.ndarray]]:
    """One node per (frame, label > 0) of a (T, H, W) or (T, Z, H, W) label
    stack, with its centroid and area, numbered in frame then label order;
    and each node's flat pixel indices into its frame."""
    labels = np.asarray(labels)
    if labels.ndim not in (3, 4):
        raise ValueError(f"labels must be (T,H,W) or (T,Z,H,W), got {labels.shape}")
    spatial_shape = labels.shape[1:]
    rows: list[tuple] = []
    node_pixels: dict[int, np.ndarray] = {}
    for t in range(labels.shape[0]):
        flat = labels[t].ravel()
        order = np.argsort(flat, kind="stable")
        sorted_vals = flat[order]
        start = np.searchsorted(sorted_vals, 1)
        if start == len(sorted_vals):
            continue
        vals = sorted_vals[start:]
        idx = order[start:]
        boundaries = np.flatnonzero(np.diff(vals)) + 1
        groups = np.split(idx, boundaries)
        group_labels = vals[np.concatenate(([0], boundaries))]
        for lab, pix in zip(group_labels, groups):
            centroid = tuple(map(float, np.mean(np.unravel_index(pix, spatial_shape), axis=1)))
            node_pixels[len(rows)] = pix
            rows.append((len(rows), t, int(lab), int(pix.size), *centroid))
    cols = list(NODE_COLUMNS) + (["z"] if labels.ndim == 4 else [])
    table = np.asarray(rows, dtype=np.float64).reshape(len(rows), len(cols))
    nodes: dict[str, np.ndarray] = {c: table[:, i].astype(np.int64) for i, c in enumerate(cols[:4])}
    # a row holds its centroid as (y, x) or (z, y, x)
    pos = ("z", "y", "x") if labels.ndim == 4 else ("y", "x")
    for i, c in enumerate(pos):
        nodes[c] = table[:, 4 + i]
    return {c: nodes[c] for c in cols}, node_pixels


def _positions(nodes: dict[str, np.ndarray], rows=slice(None)) -> np.ndarray:
    cols = ["z", "y", "x"] if "z" in nodes else ["y", "x"]
    return np.stack([nodes[c][rows] for c in cols], axis=1).astype(float)


def build_candidate_graph(labels: np.ndarray, distance_threshold: float = 325.0, n_neighbors: int = 10,
                          delta_t: int = 1) -> CandidateGraph:
    """Nodes, and for every node at frame ``t`` edges to up to
    ``n_neighbors`` nodes of each frame ``t - 1 .. t - delta_t`` within
    ``distance_threshold`` pixels (``tracksdata``'s ``DistanceEdges``)."""
    nodes, node_pixels = extract_nodes(labels)
    graph = CandidateGraph(nodes=nodes, edges=_empty_edges(), node_pixels=node_pixels,
                           frame_shape=tuple(labels.shape[1:]))
    if graph.num_nodes() == 0:
        return graph
    ts = nodes["t"]
    by_t = {int(t): np.flatnonzero(ts == t) for t in np.unique(ts)}
    trees = {t: cKDTree(_positions(nodes, rows)) for t, rows in by_t.items()}
    srcs, tgts, dists, dts = [], [], [], []
    for t, rows_t in by_t.items():
        pos = _positions(nodes, rows_t)
        ids_t = nodes["node_id"][rows_t]
        for dt in range(1, delta_t + 1):
            prev = by_t.get(t - dt)
            if prev is None:
                continue
            k = min(n_neighbors, len(prev))
            dist, nbr = trees[t - dt].query(pos, k=k, distance_upper_bound=distance_threshold)
            dist = np.atleast_2d(dist.T).T  # (n, k) even when k == 1
            nbr = np.atleast_2d(nbr.T).T
            r, c = np.nonzero(np.isfinite(dist))
            srcs.append(nodes["node_id"][prev][nbr[r, c]])
            tgts.append(ids_t[r])
            dists.append(dist[r, c])
            dts.append(np.full(r.shape, dt, dtype=np.int64))
    if srcs:
        graph.edges = {"source": np.concatenate(srcs), "target": np.concatenate(tgts), "dist": np.concatenate(dists),
                       "delta_t": np.concatenate(dts)}
    return graph


def add_iou_attr(graph: CandidateGraph, key: str = "iou") -> None:
    """Each edge's mask IoU from the nodes' flat pixel indices (the
    baseline's ``IoUEdgeAttr``)."""
    ious = np.zeros(graph.num_edges(), dtype=float)
    for i, (s, t) in enumerate(zip(graph.edges["source"], graph.edges["target"])):
        a = graph.node_pixels[int(s)]
        b = graph.node_pixels[int(t)]
        inter = np.intersect1d(a, b, assume_unique=True).size
        if inter:
            ious[i] = inter / (a.size + b.size - inter)
    graph.edges[key] = ious
