"""Track CTC sequences and score them (counterpart of
``viscy_tpu/apps/dynaclr/tracking_benchmark/evaluate.py``).

Per (model, dataset, sequence): read the error segmentation, the raw
frames and the GT, build the candidate graph, weight its edges by the
embeddings' cosine similarity (or the IoU + distance baseline), solve the
ILP on the host, score against the GT, and write ``results.csv`` after each
sequence. The encoders run on ``device`` (the card unless ``"cpu"``).

Departures from JAX (``ROADMAP.md`` Queue 3): a sequence that fails raises
(JAX logs it and leaves it out of ``results.csv``); a sequence without its
``{seq}_ERR_SEG`` directory is skipped with a warning, as in JAX. The CSVs
hold the text pandas writes (``results.csv`` the rows, ``summary.csv`` the
mean of each key metric by (model, dataset), NaN skipped, pandas' Kahan
sum); :func:`run_tracking_accuracy` returns the rows as dicts.
"""

from __future__ import annotations

import importlib
import logging
import math
import time
from pathlib import Path

import numpy as np

from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.config import (
    CTCDatasetEntry,
    EmbeddingModelEntry,
    TrackingAccuracyConfig,
)
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.ctc import (
    load_ctc_ground_truth,
    load_tiff_stack,
    seg_dir,
    tracking_to_ctc,
)
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.embedding import (
    add_embedding_similarity,
    compute_node_embeddings,
    make_torch_embedder,
)
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.graph import add_iou_attr, build_candidate_graph
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.metrics import TrackingAnnotation, evaluate_ctc_metrics
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.solver import solve_tracking
from viscy_tpu_torch.training.cli_utils import rows_to_csv

_logger = logging.getLogger(__name__)

__all__ = ["run_tracking_accuracy", "track_single_dataset", "track_arrays", "resolve_embed_fn", "summarize"]

KEY_METRICS = ("LNK", "BIO(0)", "OP_CLB(0)", "CHOTA", "TRA", "DET")


def _load_ctc_metadata(path: Path) -> dict[str, float]:
    """Dataset name -> x pixel size (um); YAML rows are ``name:
    [interval_min, y_um, x_um]``."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    return {name: values[2] for name, values in raw.items() if isinstance(values, list)}


def resolve_embed_fn(entry: EmbeddingModelEntry, device: str = "cuda"):
    """The entry's ``embed_fn`` (``None`` for the baseline): a
    ``"module:attr"`` factory called with no arguments, or a ``.pt`` state
    dict or ``viscy-torch fit`` checkpoint loaded into
    ``model_class(**model_init_args)`` and run by
    :func:`~.embedding.make_torch_embedder` on ``device``."""
    if entry.path is None:
        return None
    if ":" in str(entry.path) and not Path(entry.path).exists():
        mod_name, attr = str(entry.path).split(":", 1)
        return getattr(importlib.import_module(mod_name), attr)()
    from viscy_tpu_torch.training.instantiate import resolve_class
    from viscy_tpu_torch.training.trainer import read_checkpoint

    if entry.model_class is None:
        raise ValueError(f"model entry '{entry.label}' needs model_class for checkpoint loading")
    path = Path(entry.path)
    if path.is_dir():
        raise ValueError(
            f"model entry '{entry.label}': {path} is a directory, an Orbax checkpoint of the JAX package, which "
            "viscy_tpu_torch cannot read: convert its params with viscy_tpu_torch.training.convert "
            "(contrastive_state_dict_from_flax), torch.save the state dict and name that file as path")
    model = resolve_class(entry.model_class)(**entry.model_init_args)
    _, state = read_checkpoint(path)
    state = {k: v for k, v in state.items() if not k.startswith("aux_heads.")}
    # BatchNorm step counters have no flax counterpart: a bridged state dict lacks them
    state.update({k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked") and k not in state})
    model.load_state_dict(state, strict=True)
    return make_torch_embedder(model, device)


def track_arrays(images: np.ndarray, labels: np.ndarray, config: TrackingAccuracyConfig, embed_fn=None,
                 pixel_size_scale: float = 1.0, stats: dict | None = None):
    """Build, weight and solve on stacks in memory; ``(candidate graph,
    solution)``. ``stats``, when given, receives the node and edge counts,
    the seconds of the crops, the embedding and the solve, and the ILP's
    variables and objective (``x``, ``objective``)."""
    stats = {} if stats is None else stats
    graph = build_candidate_graph(labels, distance_threshold=config.distance_threshold,
                                  n_neighbors=config.n_neighbors, delta_t=config.delta_t)
    stats.update(nodes=graph.num_nodes(), edges=graph.num_edges())
    _logger.info("nodes=%d candidate edges=%d", graph.num_nodes(), graph.num_edges())
    if graph.num_edges() == 0:
        return graph, solve_tracking(graph, solution=stats)
    dist_weight = np.exp(-np.asarray(graph.edges["dist"], float) / config.distance_threshold)
    if embed_fn is not None:
        seconds: dict = {}
        emb = compute_node_embeddings(graph, images, embed_fn, model_input_shape=config.model_input_shape,
                                      batch_size=config.batch_size, pixel_size_scale=pixel_size_scale,
                                      seconds=seconds)
        stats.update(crops_s=seconds["crops"], embedding_s=seconds["embedding"])
        add_embedding_similarity(graph, emb)
        edge_weight = -np.asarray(graph.edges["dynaclr_similarity"], float) * dist_weight
    else:
        add_iou_attr(graph)
        edge_weight = -(np.asarray(graph.edges["iou"], float) + 0.1) * dist_weight
    # long-gap edges are discounted, as in the reference
    graph.edges["weight"] = edge_weight / np.maximum(np.asarray(graph.edges["delta_t"], float), 1.0)
    t0 = time.perf_counter()
    solution = solve_tracking(graph, appearance_weight=config.appearance_weight,
                              disappearance_weight=config.disappearance_weight,
                              division_weight=config.division_weight, node_weight=config.node_weight,
                              time_limit=config.solver_time_limit, solution=stats)
    stats["solve_s"] = time.perf_counter() - t0
    return graph, solution


def track_single_dataset(dataset_entry: CTCDatasetEntry, sequence: str, model_entry: EmbeddingModelEntry,
                         config: TrackingAccuracyConfig, device: str = "cuda", stats: dict | None = None) -> dict:
    """Track one CTC sequence and score it: the metrics, then ``model``,
    ``dataset`` and ``sequence``."""
    dataset_dir = Path(dataset_entry.path)
    _seg_dir = seg_dir(dataset_dir, sequence)
    if not _seg_dir.exists():
        raise FileNotFoundError(f"segmentation directory not found: {_seg_dir}")
    labels = load_tiff_stack(_seg_dir)
    images = load_tiff_stack(dataset_dir / sequence)
    gt = load_ctc_ground_truth(dataset_dir / f"{sequence}_GT" / "TRA")

    dataset_pixel_size = dataset_entry.pixel_size_um
    if dataset_pixel_size is None and config.ctc_metadata_path is not None:
        dataset_pixel_size = _load_ctc_metadata(Path(config.ctc_metadata_path)).get(dataset_dir.name)
        if dataset_pixel_size is None:
            _logger.warning("dataset %s not in %s; no rescaling", dataset_dir.name, config.ctc_metadata_path)
    if model_entry.pixel_size_um is not None and dataset_pixel_size is not None:
        pixel_size_scale = dataset_pixel_size / model_entry.pixel_size_um
    else:
        pixel_size_scale = 1.0

    embed_fn = resolve_embed_fn(model_entry, device)
    graph, solution = track_arrays(images, labels, config, embed_fn=embed_fn, pixel_size_scale=pixel_size_scale,
                                   stats=stats)
    res_masks, res_tracks = tracking_to_ctc(solution, graph.node_pixels, graph.frame_shape, len(labels))
    metrics = evaluate_ctc_metrics(TrackingAnnotation(masks=res_masks, tracks=res_tracks),
                                   TrackingAnnotation(masks=gt.masks, tracks=gt.tracks), metrics=config.ctc_metrics)
    metrics["model"] = model_entry.label
    metrics["dataset"] = dataset_dir.name
    metrics["sequence"] = sequence
    return metrics


def summarize(rows: list[dict]) -> list[dict]:
    """``df.groupby(["model", "dataset"])[key metrics].mean()``, sorted by
    (model, dataset): NaN skipped, each mean a Kahan sum over its count, as
    pandas' ``group_mean`` computes it."""
    keys = [c for c in KEY_METRICS if any(c in r for r in rows)]
    groups: dict[tuple, list[dict]] = {}
    for r in rows:
        groups.setdefault((r["model"], r["dataset"]), []).append(r)
    out = []
    for (model, dataset), members in sorted(groups.items()):
        row = {"model": model, "dataset": dataset}
        for k in keys:
            total = comp = 0.0
            n = 0
            for r in members:
                v = float(r.get(k, math.nan))
                if math.isnan(v):
                    continue
                n += 1
                y = v - comp
                t = total + y
                comp = t - total - y
                if comp != comp:
                    comp = 0.0
                total = t
            row[k] = total / n if n else math.nan
        out.append(row)
    return out


def run_tracking_accuracy(config: TrackingAccuracyConfig, device: str = "cuda",
                          stats: list | None = None) -> list[dict]:
    """Every model x dataset x sequence, ``results.csv`` rewritten after each
    sequence and ``summary.csv`` at the end; the rows. ``stats``, when given,
    receives one dict a sequence (see :func:`track_arrays`) with its model,
    dataset and sequence."""
    output_dir = Path(config.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    results: list[dict] = []
    for model_entry in config.models:
        for dataset_entry in config.datasets:
            dataset_dir = Path(dataset_entry.path)
            for sequence in dataset_entry.sequences:
                _seg = seg_dir(dataset_dir, sequence)
                if not _seg.exists():
                    _logger.warning("skipping %s/%s: no segmentation at %s", dataset_dir.name, sequence, _seg)
                    continue
                seq_stats = {"model": model_entry.label, "dataset": dataset_dir.name, "sequence": sequence}
                try:
                    row = track_single_dataset(dataset_entry, sequence, model_entry, config, device=device,
                                               stats=seq_stats)
                except Exception as e:
                    raise RuntimeError(f"tracking failed: {model_entry.label} / {dataset_dir.name} / {sequence} "
                                       "(JAX logs this and leaves the sequence out; the port raises)") from e
                if stats is not None:
                    stats.append(seq_stats)
                results.append(row)
                (output_dir / "results.csv").write_text(rows_to_csv(results))
    if results:
        summary = summarize(results)
        if len(summary[0]) > 2:
            (output_dir / "summary.csv").write_text(rows_to_csv(summary))
    return results
