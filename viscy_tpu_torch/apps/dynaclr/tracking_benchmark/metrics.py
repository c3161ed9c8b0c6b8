"""CTC tracking metrics: AOGM, the biological measures and CHOTA
(counterpart of ``viscy_tpu/apps/dynaclr/tracking_benchmark/metrics.py``,
which implements the published definitions in place of ``py-ctcmetrics``).

- DET / TRA: the AOGM node and edge edit distance (Matula et al. 2015;
  weights NS 5, FN 10, FP 1, ED 1, EA 1.5, EC 1).
- LNK: the edge-only AOGM.
- CT / TF / BC(i) / CCA: the biological measures (Ulman et al. 2017);
  BIO(i) their mean, OP_CLB(i) = (LNK + BIO(i)) / 2.
- CHOTA: the cell-specific HOTA (Kaiser et al. 2024).

Each side is a label stack whose labels are track ids and a track table
(column dict ``track_id, t_start, t_end, parent_track``). The per-frame
overlaps are counted by ``bincount`` over ``(gt, result)`` label pairs
(JAX: ``np.unique`` of the pairs), visited in the same (gt, result)
order, and every set and dict is filled in JAX's order, so the sums come
out bit for bit as JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["evaluate_ctc_metrics", "TrackingAnnotation", "ALL_METRICS"]

W_NS, W_FN, W_FP, W_ED, W_EA, W_EC = 5.0, 10.0, 1.0, 1.0, 1.5, 1.0

ALL_METRICS = ("DET", "TRA", "LNK", "CT", "TF", "BC(0)", "CCA", "BIO(0)", "OP_CLB(0)", "CHOTA")


def _labels(frame: np.ndarray) -> np.ndarray:
    """The labels > 0 present in a frame, ascending."""
    flat = frame.ravel()
    if flat.dtype.kind == "u" or (flat.size and flat.min() >= 0):
        present = np.flatnonzero(np.bincount(flat.astype(np.int64)))
    else:
        present = np.unique(flat)
    return present[present > 0]


@dataclass
class TrackingAnnotation:
    """One side (GT or result) of a CTC comparison."""

    masks: np.ndarray  # (T, ...) labels = track ids
    tracks: dict[str, np.ndarray]
    _nodes: set | None = field(default=None, repr=False)

    def nodes(self) -> set[tuple[int, int]]:
        """Every (track_id, t) detection in the masks."""
        if self._nodes is None:
            self._nodes = {(int(tid), t) for t in range(len(self.masks)) for tid in _labels(self.masks[t])}
        return self._nodes

    def _rows(self):
        return zip(self.tracks["track_id"].tolist(), self.tracks["parent_track"].tolist())

    def edges(self) -> dict[tuple[tuple[int, int], tuple[int, int]], bool]:
        """Temporal edges -> is_parent_link."""
        nodes_by_track: dict[int, list[int]] = {}
        for tid, t in self.nodes():
            nodes_by_track.setdefault(tid, []).append(t)
        for ts in nodes_by_track.values():
            ts.sort()
        edges: dict[tuple[tuple[int, int], tuple[int, int]], bool] = {}
        for tid, ts in nodes_by_track.items():
            for a, b in zip(ts[:-1], ts[1:]):
                edges[((tid, a), (tid, b))] = False
        for tid, parent in self._rows():
            if parent > 0 and parent in nodes_by_track and tid in nodes_by_track:
                edges[((parent, nodes_by_track[parent][-1]), (tid, nodes_by_track[tid][0]))] = True
        return edges

    def lineage_sets(self) -> dict[int, set[int]]:
        """track_id -> the ids of its whole cell history (itself, its
        ancestors and its descendants)."""
        parent = dict(self._rows())
        children: dict[int, list[int]] = {}
        for tid, p in parent.items():
            if p > 0:
                children.setdefault(p, []).append(tid)
        out: dict[int, set[int]] = {}
        for tid in parent:
            hist = {tid}
            p = parent.get(tid, 0)
            while p > 0:
                hist.add(p)
                p = parent.get(p, 0)
            stack = [tid]
            while stack:
                cur = stack.pop()
                for kid in children.get(cur, ()):
                    if kid not in hist:
                        hist.add(kid)
                        stack.append(kid)
            out[tid] = hist
        return out


def _frame_matching(gt_frame: np.ndarray, res_frame: np.ndarray):
    """The CTC detection test of one frame: GT marker g matches result label
    r iff |r and g| > |g| / 2. Returns (gt -> res, res -> [gt], unmatched
    GT labels, result labels covering no GT marker)."""
    gt = gt_frame.ravel().astype(np.int64)
    res = res_frame.ravel().astype(np.int64)
    gt_sizes = np.bincount(gt[gt > 0])
    gt_ids = np.flatnonzero(gt_sizes)
    res_ids = _labels(res_frame)
    both = (gt > 0) & (res > 0)
    gt_to_res: dict[int, int] = {}
    res_to_gt: dict[int, list[int]] = {}
    if both.any():
        # pairs keyed by their labels' ranks: ascending keys are (g, r) in
        # lexicographic order, as np.unique gives them
        gi = np.searchsorted(gt_ids, gt[both])
        ri = np.searchsorted(res_ids, res[both])
        counts = np.bincount(gi * len(res_ids) + ri)
        keys = np.flatnonzero(counts)
        for key, cnt in zip(keys.tolist(), counts[keys].tolist()):
            g, r = int(gt_ids[key // len(res_ids)]), int(res_ids[key % len(res_ids)])
            if cnt > 0.5 * int(gt_sizes[g]):
                gt_to_res[g] = r
                res_to_gt.setdefault(r, []).append(g)
    fn = [int(g) for g in gt_ids if int(g) not in gt_to_res]
    fp = [int(r) for r in res_ids if int(r) not in res_to_gt]
    return gt_to_res, res_to_gt, fn, fp


@dataclass
class _MatchState:
    ns: int = 0
    fn: int = 0
    fp: int = 0
    gt_node_to_res: dict = field(default_factory=dict)  # (gt_track, t) -> (res_track, t)
    tp_pairs: list = field(default_factory=list)  # [((g, t), (r, t)), ...]


def _match_all_frames(gt_masks: np.ndarray, res_masks: np.ndarray) -> _MatchState:
    st = _MatchState()
    n_frames = min(len(gt_masks), len(res_masks))
    for t in range(n_frames):
        gt_to_res, res_to_gt, fn, fp = _frame_matching(gt_masks[t], res_masks[t])
        st.fn += len(fn)
        st.fp += len(fp)
        for gs in res_to_gt.values():
            st.ns += len(gs) - 1
        for g, r in gt_to_res.items():
            st.gt_node_to_res[(g, t)] = (r, t)
            st.tp_pairs.append(((g, t), (r, t)))
    for t in range(n_frames, len(gt_masks)):  # GT frames beyond the result are all FN
        st.fn += int(np.count_nonzero(np.unique(gt_masks[t])))
    return st


def evaluate_ctc_metrics(result: TrackingAnnotation, ground_truth: TrackingAnnotation,
                         metrics: list[str] | None = None) -> dict[str, float]:
    """The CTC tracking metrics of a result against the ground truth
    (``metrics``: a subset of :data:`ALL_METRICS`; ``None``: all)."""
    wanted = list(metrics) if metrics is not None else list(ALL_METRICS)
    st = _match_all_frames(ground_truth.masks, result.masks)
    gt_nodes = ground_truth.nodes()
    gt_edges = ground_truth.edges()
    res_edges = result.edges()

    # a GT edge is reconstructed iff the result links its matched nodes
    matched_gt_edges: set = set()
    gt_edge_of_res: dict = {}
    for (g1, g2), is_parent in gt_edges.items():
        r1 = st.gt_node_to_res.get(g1)
        r2 = st.gt_node_to_res.get(g2)
        if r1 is None or r2 is None:
            continue
        key = ((r1[0], r1[1]), (r2[0], r2[1]))
        if key in res_edges:
            matched_gt_edges.add((g1, g2))
            gt_edge_of_res.setdefault(key, []).append(((g1, g2), is_parent))
    ea = len(gt_edges) - len(matched_gt_edges)
    ec = sum(gt_parent != res_edges[key] for key, lst in gt_edge_of_res.items() for _, gt_parent in lst)
    ed = len(res_edges) - len(gt_edge_of_res)

    out: dict[str, float] = {}
    aogm_d = W_NS * st.ns + W_FN * st.fn + W_FP * st.fp
    aogm_d0 = W_FN * len(gt_nodes)
    aogm_a = W_ED * ed + W_EA * ea + W_EC * ec
    aogm_a0 = W_EA * len(gt_edges)
    lnk = 1.0 - min(aogm_a, aogm_a0) / aogm_a0 if aogm_a0 else 1.0
    if "DET" in wanted:
        out["DET"] = 1.0 - min(aogm_d, aogm_d0) / aogm_d0 if aogm_d0 else 1.0
    if "TRA" in wanted:
        denom = aogm_d0 + aogm_a0
        out["TRA"] = 1.0 - min(aogm_d + aogm_a, denom) / denom if denom else 1.0
    if "LNK" in wanted:
        out["LNK"] = lnk
    if {"CT", "TF", "BC(0)", "CCA", "BIO(0)", "OP_CLB(0)"} & set(wanted):
        bio = _biological_metrics(result, ground_truth, st)
        for k in ("CT", "TF", "BC(0)", "CCA"):
            if k in wanted:
                out[k] = bio[k]
        if "BIO(0)" in wanted or "OP_CLB(0)" in wanted:
            avail = [bio[k] for k in ("CT", "TF", "BC(0)", "CCA") if not np.isnan(bio[k])]
            bio0 = float(np.mean(avail)) if avail else float("nan")
            if "BIO(0)" in wanted:
                out["BIO(0)"] = bio0
            if "OP_CLB(0)" in wanted:
                out["OP_CLB(0)"] = 0.5 * (lnk + bio0)
    if "CHOTA" in wanted:
        out["CHOTA"] = _chota(result, ground_truth, st, gt_nodes)
    return out


def _track_node_lists(ann: TrackingAnnotation) -> dict[int, list[tuple[int, int]]]:
    by_track: dict[int, list[tuple[int, int]]] = {}
    for tid, t in ann.nodes():
        by_track.setdefault(tid, []).append((tid, t))
    for v in by_track.values():
        v.sort(key=lambda n: n[1])
    return by_track


def _biological_metrics(result: TrackingAnnotation, ground_truth: TrackingAnnotation, st: _MatchState) -> dict:
    """CT, TF, BC(0) and CCA."""
    gt_tracks = _track_node_lists(ground_truth)
    res_tracks = _track_node_lists(result)
    res_track_of = {g: r[0] for g, r in st.gt_node_to_res.items()}

    # CT: a GT track is complete iff all its nodes match into one result
    # track of the same length; normalized over both track counts
    n_complete = 0
    for gnodes in gt_tracks.values():
        rids = {res_track_of.get(g) for g in gnodes}
        if None in rids or len(rids) != 1:
            continue
        if len(res_tracks.get(next(iter(rids)), [])) == len(gnodes):
            n_complete += 1
    denom = len(gt_tracks) + len(res_tracks)
    ct = 2.0 * n_complete / denom if denom else float("nan")

    # TF: the mean over GT tracks of the longest run matched to one result
    # track over consecutive frames, as a fraction of the track
    fractions = []
    for gnodes in gt_tracks.values():
        best = cur = 0
        prev_rid = prev_t = None
        for g in gnodes:
            rid = res_track_of.get(g)
            if rid is not None and rid == prev_rid and prev_t == g[1] - 1:
                cur += 1
            else:
                cur = 1 if rid is not None else 0
            best = max(best, cur)
            prev_rid, prev_t = rid, g[1]
        fractions.append(best / len(gnodes))
    tf = float(np.mean(fractions)) if fractions else float("nan")

    # BC(0): F1 of division events at tolerance 0
    gt_divs = _division_events(ground_truth, gt_tracks)
    res_divs = _division_events(result, res_tracks)
    matched = 0
    for parent_node, t in gt_divs:
        rid = res_track_of.get(parent_node)
        if rid is not None and any(rt == t and rn[0] == rid for rn, rt in res_divs):
            matched += 1
    if gt_divs or res_divs:
        precision = matched / len(res_divs) if res_divs else 0.0
        recall = matched / len(gt_divs) if gt_divs else 0.0
        bc = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    else:
        bc = float("nan")

    # CCA: 1 - the sup-norm distance of the complete cell-cycle length CDFs
    gt_cycles = _cycle_lengths(ground_truth, gt_tracks)
    res_cycles = _cycle_lengths(result, res_tracks)
    cca = 1.0 - _cdf_distance(gt_cycles, res_cycles) if gt_cycles else float("nan")
    return {"CT": ct, "TF": tf, "BC(0)": bc, "CCA": cca}


def _children_counts(ann: TrackingAnnotation) -> dict[int, int]:
    kids: dict[int, int] = {}
    for _, p in ann._rows():
        if p > 0:
            kids[p] = kids.get(p, 0) + 1
    return kids


def _division_events(ann: TrackingAnnotation, tracks: dict) -> list[tuple[tuple[int, int], int]]:
    """[(the parent's last node, the division frame)] of parents with at
    least two children."""
    events = []
    for p, n in _children_counts(ann).items():
        if n >= 2 and p in tracks and tracks[p]:
            last = tracks[p][-1]
            events.append((last, last[1]))
    return events


def _cycle_lengths(ann: TrackingAnnotation, tracks: dict) -> list[int]:
    """Lengths of complete cycles: tracks born of a division that divide."""
    parent = dict(ann._rows())
    nkids = _children_counts(ann)
    return [nodes[-1][1] - nodes[0][1] + 1 for tid, nodes in tracks.items()
            if parent.get(tid, 0) > 0 and nkids.get(tid, 0) >= 2 and nodes]


def _cdf_distance(a: list[int], b: list[int]) -> float:
    """The Kolmogorov-Smirnov distance of two samples (1 if ``b`` is empty)."""
    if not b:
        return 1.0
    grid = np.unique(np.concatenate([a, b]))
    ca = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    cb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return float(np.max(np.abs(ca - cb)))


def _chota(result: TrackingAnnotation, ground_truth: TrackingAnnotation, st: _MatchState, gt_nodes: set) -> float:
    """sqrt(sum over TP pairs of the Jaccard agreement of the two cells'
    whole histories / (TP + FN + FP))."""
    tp = len(st.tp_pairs)
    denom = tp + st.fn + st.fp
    if denom == 0:
        return 1.0
    if tp == 0:
        return 0.0
    gt_hist = ground_truth.lineage_sets()
    res_hist = result.lineage_sets()
    gt_track_size: dict[int, int] = {}
    res_track_size: dict[int, int] = {}
    for tid, _ in gt_nodes:
        gt_track_size[tid] = gt_track_size.get(tid, 0) + 1
    for tid, _ in result.nodes():
        res_track_size[tid] = res_track_size.get(tid, 0) + 1
    pair_tp: dict[tuple[int, int], int] = {}
    for (g, _), (r, _) in st.tp_pairs:
        pair_tp[(g, r)] = pair_tp.get((g, r), 0) + 1
    cache: dict[tuple[int, int], float] = {}

    def _assoc(g: int, r: int) -> float:
        if (g, r) not in cache:
            gh = gt_hist.get(g, {g})
            rh = res_hist.get(r, {r})
            inter = sum(cnt for (gg, rr), cnt in pair_tp.items() if gg in gh and rr in rh)
            union = sum(gt_track_size.get(t, 0) for t in gh) + sum(res_track_size.get(t, 0) for t in rh) - inter
            cache[(g, r)] = inter / union if union else 0.0
        return cache[(g, r)]

    total = sum(_assoc(g, r) for (g, _), (r, _) in st.tp_pairs)
    return float(np.sqrt(total / denom))
