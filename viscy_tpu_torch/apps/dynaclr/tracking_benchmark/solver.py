"""The tracking ILP on scipy's HiGHS MILP (counterpart of
``viscy_tpu/apps/dynaclr/tracking_benchmark/solver.py``), with JAX's
variables, constraint matrix and cost vector.

Per node: selected ``n``, appearance, disappearance, division; per
candidate edge: selected ``x``. Constraints:

    sum_in(v)  x_e + app_v = n_v
    sum_out(u) x_e + dis_u = n_u + div_u
    div_u <= n_u

Minimized: ``sum_e w_e x_e + appearance_weight * app +
disappearance_weight * dis + division_weight * div + node_weight * n``.
The optimum need not be unique, and HiGHS picks among ties by its
version; :func:`ilp_problem` gives the arrays to check a solution against.

Departure from JAX (``ROADMAP.md`` Queue 3), exact: the port first solves
the LP relaxation (``milp`` with no integrality) and, when its optimum is
integral, takes it, since it is then an optimum of the ILP; otherwise it
runs JAX's MILP. On a 40-frame sequence of 1024^2 frames with 30 nuclei
(40,000 candidate edges) the relaxation was integral and took 0.3-0.4 s on
an 8-core Intel Xeon host, where the MILP took 36-70 s, nearly all of it in
HiGHS's root analytic centre. Every solution is checked against the flow
constraints.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp
from scipy.sparse import coo_matrix

from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.ctc import track_table
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.graph import CandidateGraph, TrackingGraph, take

__all__ = ["ilp_problem", "solve_tracking", "solution_to_tracks"]


def ilp_problem(graph: CandidateGraph, edge_weight_key: str = "weight", appearance_weight: float = 0.0,
                disappearance_weight: float = 0.0, division_weight: float = 0.5,
                node_weight: float = -10.0) -> tuple[np.ndarray, object, np.ndarray, np.ndarray]:
    """``(c, A, lb, ub)`` of the ILP: variables ``[x_e (m), n_v (n), app_v
    (n), dis_v (n), div_v (n)]``, rows ``lb <= A x <= ub``."""
    nodes, edges = graph.nodes, graph.edges
    n, m = graph.num_nodes(), graph.num_edges()
    node_pos = {int(nid): i for i, nid in enumerate(nodes["node_id"])}
    src = np.array([node_pos[int(s)] for s in edges["source"]], dtype=int)
    tgt = np.array([node_pos[int(t)] for t in edges["target"]], dtype=int)
    off_n, off_app, off_dis, off_div = m, m + n, m + 2 * n, m + 3 * n
    nvar = m + 4 * n
    c = np.zeros(nvar)
    if m:
        c[:m] = np.asarray(edges[edge_weight_key], float)
    c[off_n:off_n + n] = node_weight
    c[off_app:off_app + n] = appearance_weight
    c[off_dis:off_dis + n] = disappearance_weight
    c[off_div:off_div + n] = division_weight

    rows: list[np.ndarray] = []
    cols: list[np.ndarray] = []
    vals: list[np.ndarray] = []

    def _add(r, cc, v):
        rows.append(np.asarray(r, dtype=int))
        cols.append(np.asarray(cc, dtype=int))
        vals.append(np.asarray(v, dtype=float))

    # rows 0..n-1: sum_in(v) + app_v - n_v = 0
    if m:
        _add(tgt, np.arange(m), np.ones(m))
    _add(np.arange(n), off_app + np.arange(n), np.ones(n))
    _add(np.arange(n), off_n + np.arange(n), -np.ones(n))
    # rows n..2n-1: sum_out(u) + dis_u - n_u - div_u = 0
    if m:
        _add(n + src, np.arange(m), np.ones(m))
    _add(n + np.arange(n), off_dis + np.arange(n), np.ones(n))
    _add(n + np.arange(n), off_n + np.arange(n), -np.ones(n))
    _add(n + np.arange(n), off_div + np.arange(n), -np.ones(n))
    # rows 2n..3n-1: div_u - n_u <= 0
    _add(2 * n + np.arange(n), off_div + np.arange(n), np.ones(n))
    _add(2 * n + np.arange(n), off_n + np.arange(n), -np.ones(n))

    A = coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(3 * n, nvar)).tocsr()
    lb = np.concatenate([np.zeros(2 * n), np.full(n, -np.inf)])
    ub = np.concatenate([np.zeros(2 * n), np.zeros(n)])
    return c, A, lb, ub


def solve_tracking(graph: CandidateGraph, edge_weight_key: str = "weight", appearance_weight: float = 0.0,
                   disappearance_weight: float = 0.0, division_weight: float = 0.5, node_weight: float = -10.0,
                   time_limit: float | None = None, solution: dict | None = None) -> TrackingGraph:
    """Solve the ILP (``edges[edge_weight_key]`` the edge costs, lower is
    better) and return the selected subgraph with its tracks. ``solution``,
    when given, receives the variable vector ``x`` and the objective."""
    n, m = graph.num_nodes(), graph.num_edges()
    if n == 0:
        return TrackingGraph(nodes=graph.nodes, edges=graph.edges, tracks=track_table(np.zeros((0, 4))))
    c, A, lb, ub = ilp_problem(graph, edge_weight_key, appearance_weight, disappearance_weight, division_weight,
                               node_weight)
    options = {}
    if time_limit is not None:
        options["time_limit"] = time_limit
    problem = dict(c=c, constraints=LinearConstraint(A, lb, ub), bounds=Bounds(np.zeros(len(c)), np.ones(len(c))),
                   options=options)
    # the LP relaxation first: an integral optimum of it is an optimum of the ILP
    res = milp(integrality=np.zeros(len(c)), **problem)
    if res.x is None or np.abs(res.x - np.round(res.x)).max() > 1e-9:
        res = milp(integrality=np.ones(len(c)), **problem)
    if res.x is None:
        raise RuntimeError(f"tracking ILP failed: {res.message}")
    x = np.round(res.x).astype(int)
    ax = A @ x
    if not (np.all(ax >= lb - 1e-6) and np.all(ax <= ub + 1e-6)):
        raise RuntimeError("tracking ILP: the rounded solution breaks the flow constraints")
    if solution is not None:
        solution.update(x=x, objective=float(res.fun))
    sel_edges = take(graph.edges, x[:m] == 1)
    sel_nodes = take(graph.nodes, x[m:m + n] == 1)
    return solution_to_tracks(sel_nodes, sel_edges)


def solution_to_tracks(sel_nodes: dict[str, np.ndarray], sel_edges: dict[str, np.ndarray]) -> TrackingGraph:
    """CTC track ids for a solved subgraph: a track is a maximal chain of
    nodes with one child each; a division (two children) ends the parent
    track and starts a child track for each, ``parent_track`` set."""
    children: dict[int, list[int]] = {}
    parent_of: dict[int, int] = {}
    for s, t in zip(sel_edges["source"], sel_edges["target"]):
        children.setdefault(int(s), []).append(int(t))
        parent_of[int(t)] = int(s)
    node_t = dict(zip(sel_nodes["node_id"].astype(int).tolist(), sel_nodes["t"].astype(int).tolist()))
    track_of_node: dict[int, int] = {}
    track_rows: list[tuple[int, int, int, int]] = []
    next_track = 1
    roots = sorted((nid for nid in node_t if nid not in parent_of), key=lambda nid: (node_t[nid], nid))
    stack = [(nid, 0) for nid in reversed(roots)]  # (start node, parent track)
    while stack:
        nid, parent_track = stack.pop()
        tid = next_track
        next_track += 1
        t_start = node_t[nid]
        cur = nid
        while True:
            track_of_node[cur] = tid
            kids = children.get(cur, [])
            if len(kids) != 1:
                break
            cur = kids[0]  # gap-closing edges (delta_t > 1) keep the track, as in CTC
        track_rows.append((tid, t_start, node_t[cur], parent_track))
        for kid in sorted(children.get(cur, [])):
            stack.append((kid, tid))
    nodes = dict(sel_nodes)
    nodes["track_id"] = np.asarray([track_of_node.get(int(nid), 0) for nid in sel_nodes["node_id"]], dtype=np.int64)
    return TrackingGraph(nodes=nodes, edges=sel_edges, tracks=track_table(track_rows))
