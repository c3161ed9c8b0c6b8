"""The CTC tracking-accuracy benchmark with DynaCLR embeddings (counterpart
of ``viscy_tpu/apps/dynaclr/tracking_benchmark``; reference
``dynaclr/evaluation/benchmarking/tracking_accuracy``).

Candidate graphs from ``scipy.spatial.cKDTree`` (:mod:`.graph`), the
tracking ILP on scipy's HiGHS MILP (:mod:`.solver`), node embeddings from
an encoder on the card (:mod:`.embedding`), CTC ground truth and results
through the port's own TIFF codec (:mod:`.ctc`), and the CTC metrics
(:mod:`.metrics`), driven by :mod:`.evaluate` (``python -m
viscy_tpu_torch.apps.dynaclr.cli evaluate-tracking-accuracy -c``).
"""

from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.config import (
    CTCDatasetEntry,
    EmbeddingModelEntry,
    TrackingAccuracyConfig,
)
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.ctc import load_ctc_ground_truth, write_ctc_result
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.evaluate import run_tracking_accuracy, track_single_dataset
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.graph import (
    CandidateGraph,
    TrackingGraph,
    build_candidate_graph,
    extract_nodes,
)
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.metrics import evaluate_ctc_metrics
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.solver import solve_tracking

__all__ = [
    "CTCDatasetEntry",
    "EmbeddingModelEntry",
    "TrackingAccuracyConfig",
    "CandidateGraph",
    "TrackingGraph",
    "build_candidate_graph",
    "extract_nodes",
    "solve_tracking",
    "evaluate_ctc_metrics",
    "load_ctc_ground_truth",
    "write_ctc_result",
    "run_tracking_accuracy",
    "track_single_dataset",
]
