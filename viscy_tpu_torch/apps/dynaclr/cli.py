"""``dynaclr`` command line (counterpart of
``viscy_tpu/apps/dynaclr/cli.py``):

    python -m viscy_tpu_torch.apps.dynaclr.cli [--device cuda|cpu] <subcommand> ...

The evaluation subcommands read and edit an AnnData embedding store
written by the port's ``EmbeddingWriter`` and compute on ``--device`` (the
card unless ``cpu``; without a card ``cuda`` raises). Each prints what the
JAX subcommand prints. ``fit`` and ``predict`` run ``viscy-torch``'s.
Classifier pipelines are the port's ``.npz`` files (a JAX pickle raises by
name), MLP embedders ``.pt`` + ``.json`` (JAX's ``.msgpack`` raises by name).

Departures from the reference kept from JAX (``ROADMAP.md`` Queue 3):
``combined-dim-reduction`` refuses ``umap`` and ``phate``; a missing label
in a string column that went through a store reads back as the string
``"nan"`` and counts as a label. The subcommands of later slices raise
with their name and what they wait for.

The config-driven subcommands (``evaluate-smoothness``, ``compare-models
-c``, ``mmd-analysis``, ``prepare-eval-configs``, ``evaluate-tracking-accuracy
-c``) validate JAX's YAML without pydantic and write the CSV text pandas
writes. Departures (``ROADMAP.md`` Queue 3): ``save_plots`` defaults to
false and ``save_plots: true`` is refused by name before any work (no
matplotlib on the card's machine); a sequence or model that fails raises
where JAX logs it and leaves it out; ``evaluate-tracking-accuracy -c``
prints its ``results.csv`` (JAX: the DataFrame's ``to_string``) and, on
stderr, one JSON line a sequence with its node and edge counts and the
seconds of the crops, the embedding and the solve.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import click
import numpy as np

from viscy_tpu_torch.evaluation.zarr_utils import notna


@click.group()
@click.option("--device", default="cuda", show_default=True, help="where the evaluation computes: cuda or cpu")
@click.pass_context
def main(ctx: click.Context, device: str) -> None:
    """DynaCLR: contrastive representation learning of cell dynamics."""
    ctx.obj = {"device": device}


def _device() -> str:
    return click.get_current_context().obj["device"]


def _load(path: str):
    from viscy_tpu_torch.training.callbacks.embedding_writer import read_embedding_dataset

    return read_embedding_dataset(Path(path))


def _eq(values: np.ndarray, value) -> np.ndarray:
    """``series == value`` elementwise (an int column never equals a string)."""
    return np.asarray([v == value for v in np.asarray(values).tolist()], bool)


@main.command()
@click.option("--config", "-c", required=True, type=click.Path(exists=True))
@click.option("--ckpt_path", default=None)
def fit(config: str, ckpt_path: str | None) -> None:
    """Train a DynaCLR model (``viscy-torch fit``)."""
    from viscy_tpu_torch.training.cli import run_subcommand

    run_subcommand("fit", config, ckpt_path)


@main.command()
@click.option("--config", "-c", required=True, type=click.Path(exists=True))
@click.option("--ckpt_path", default=None)
def predict(config: str, ckpt_path: str | None) -> None:
    """Extract embeddings (``viscy-torch predict``)."""
    from viscy_tpu_torch.training.cli import run_subcommand

    run_subcommand("predict", config, ckpt_path)


@main.command("train-classifier")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--label-column", required=True)
@click.option("--output", required=True, type=click.Path())
@click.option("--features-key", default="features")
def train_classifier(embeddings: str, label_column: str, output: str, features_key: str) -> None:
    """Train a linear probe on an embedding dataset (saved as ``.npz``)."""
    from viscy_tpu_torch.evaluation.linear_classifier import train_linear_classifier

    ds = _load(embeddings)
    pipeline, metrics = train_linear_classifier(ds[features_key], np.asarray(ds["index"][label_column]),
                                                device=_device())
    pipeline.save(output)
    click.echo(json.dumps(metrics, indent=2))


@main.command("cross-validate")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--label-column", required=True)
@click.option("--splits", default=5)
def cross_validate(embeddings: str, label_column: str, splits: int) -> None:
    """Stratified k-fold cross-validated probe accuracy."""
    from viscy_tpu_torch.evaluation.linear_classifier import cross_validate_classifier

    ds = _load(embeddings)
    metrics = cross_validate_classifier(ds["features"], np.asarray(ds["index"][label_column]), n_splits=splits,
                                        device=_device())
    click.echo(json.dumps(metrics, indent=2))


@main.command()
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--method", default="pca", type=click.Choice(["pca"]))
@click.option("--components", default=8)
@click.option("--output", required=True, type=click.Path())
def dimred(embeddings: str, method: str, components: int, output: str) -> None:
    """PCA of the embeddings into a ``.npy`` file."""
    from viscy_tpu_torch.evaluation.dimensionality_reduction import compute_pca

    reduced, _ = compute_pca(_load(embeddings)["features"], n_components=components, device=_device())
    reduced = reduced.astype(np.float32)
    np.save(output, reduced)
    click.echo(f"Wrote {reduced.shape} to {output}")


def _index_with_fov_name(ds):
    index = ds["index"]
    if "fov_name" not in index and "fov" in index:
        index = index.reset_index()
        index["fov_name"] = index["fov"]
    return index


@main.command()
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--distance-metric", default="cosine")
def smoothness(embeddings: str, distance_metric: str) -> None:
    """Temporal smoothness of embedding tracks."""
    from viscy_tpu_torch.evaluation.smoothness import compute_embeddings_smoothness

    ds = _load(embeddings)
    res = compute_embeddings_smoothness(ds["features"], _index_with_fov_name(ds), distance_metric, device=_device())
    click.echo(json.dumps(res, indent=2))


@main.command()
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--group-column", required=True)
@click.option("--group-a", required=True)
@click.option("--group-b", required=True)
@click.option("--permutations", default=500)
def mmd(embeddings: str, group_column: str, group_a: str, group_b: str, permutations: int) -> None:
    """MMD permutation test between two groups of embeddings."""
    from viscy_tpu_torch.evaluation.mmd import mmd_permutation_test

    ds = _load(embeddings)
    col = ds["index"][group_column]
    res = mmd_permutation_test(ds["features"][_eq(col, group_a)], ds["features"][_eq(col, group_b)],
                               n_permutations=permutations, device=_device())
    click.echo(json.dumps(res, indent=2))


@main.command("evaluate-tracking-accuracy")
@click.option("--config", "-c", "config_path", default=None, type=click.Path(exists=True),
              help="CTC benchmark config YAML (full ILP tracking + CTC metrics)")
@click.option("--embeddings", default=None, type=click.Path(exists=True),
              help="embedding store for the quick greedy-linking accuracy check")
@click.option("--spatial-gate", default=50.0, type=float)
def evaluate_tracking_accuracy(config_path: str | None, embeddings: str | None, spatial_gate: float) -> None:
    """The CTC tracking-accuracy benchmark (``-c``: candidate graph, ILP,
    DET / TRA / LNK / BIO / CHOTA), or the greedy embedding-linking accuracy
    against the ground-truth track ids (``--embeddings``)."""
    if (config_path is None) == (embeddings is None):
        raise click.UsageError("pass exactly one of --config or --embeddings")
    if config_path is not None:
        from viscy_tpu_torch.apps.dynaclr.tracking_benchmark import TrackingAccuracyConfig, run_tracking_accuracy
        from viscy_tpu_torch.training.cli_utils import load_config, rows_to_csv

        cfg = TrackingAccuracyConfig(**load_config(config_path))
        stats: list[dict] = []
        rows = run_tracking_accuracy(cfg, device=_device(), stats=stats)
        for st in stats:
            click.echo(json.dumps({k: v for k, v in st.items() if k != "x"}), err=True)
        if not rows:
            click.echo("No results produced.", err=True)
        else:
            click.echo(rows_to_csv(rows), nl=False)
            click.echo(f"\nResults written to {Path(cfg.output_dir) / 'results.csv'}")
        return
    from viscy_tpu_torch.apps.dynaclr.tracking import link_by_embedding, tracking_accuracy

    ds = _load(embeddings)
    linked = link_by_embedding(ds["features"], ds["index"], spatial_gate=spatial_gate, device=_device())
    click.echo(json.dumps(tracking_accuracy(linked), indent=2))


@main.command("append-obs")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--csv", "csv_path", required=True, type=click.Path(exists=True))
@click.option("--merge-key", default="id")
@click.option("--columns", default=None, help="comma-separated column subset")
@click.option("--prefix", default="")
def append_obs(embeddings: str, csv_path: str, merge_key: str, columns: str | None, prefix: str) -> None:
    """Merge CSV columns into the embedding index."""
    from viscy_tpu_torch.evaluation.zarr_utils import append_to_embedding_dataset, merge_csv_into_obs

    ds, stats = merge_csv_into_obs(_load(embeddings), csv_path, merge_key=merge_key,
                                   columns=columns.split(",") if columns else None, prefix=prefix)
    append_to_embedding_dataset(embeddings, obs=ds.obs)
    click.echo(json.dumps(stats, indent=2))


@main.command("reduce-dimensionality")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--method", default="pca", type=click.Choice(["pca", "umap", "phate"]))
@click.option("--components", default=8)
def reduce_dimensionality(embeddings: str, method: str, components: int) -> None:
    """Write a reduced embedding array (``obsm[METHOD]``) back into the store."""
    from viscy_tpu_torch.evaluation.dimensionality_reduction import reduce_features
    from viscy_tpu_torch.evaluation.zarr_utils import append_to_embedding_dataset

    reduced = reduce_features(_load(embeddings)["features"], method=method, n_components=components,
                              device=_device())
    append_to_embedding_dataset(embeddings, obsm={method.upper(): reduced})
    click.echo(f"Wrote {method.upper()} {reduced.shape} into {embeddings}")


@main.command("split-embeddings")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--column", required=True)
@click.option("--output-dir", required=True, type=click.Path())
def split_embeddings(embeddings: str, column: str, output_dir: str) -> None:
    """Split one store into a store per value of ``column``."""
    from viscy_tpu_torch.training.callbacks.embedding_writer import write_embedding_dataset

    ds = _load(embeddings)
    out_dir = Path(output_dir)
    index = ds["index"]
    values = np.asarray(index[column])
    for value in dict.fromkeys(values.tolist()):
        rows = np.flatnonzero(_eq(values, value))
        write_embedding_dataset(out_dir / str(value), ds["features"][rows], index.take(rows).reset_index(),
                                projections=ds["projections"][rows] if "projections" in ds else None)
        click.echo(f"{value}: {len(rows)} rows -> {out_dir / str(value)}")


@main.command("info")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
def info(embeddings: str) -> None:
    """Summarize an embedding dataset."""
    ds = _load(embeddings)
    idx = ds["index"]
    summary = {
        "n_samples": int(ds["features"].shape[0]),
        "feature_dim": int(ds["features"].shape[1]),
        "arrays": [k for k in ds if k != "index"],
        "index_columns": list(idx.names),
    }
    for col in ("experiment", "fov_name", "track_id"):
        if col in idx:
            summary[f"n_{col}"] = len({v for v, ok in zip(np.asarray(idx[col]).tolist(), notna(idx[col])) if ok})
    click.echo(json.dumps(summary, indent=2))


def write_csv(path: str | Path, rows: list[dict]) -> None:
    """Rows of dicts as a CSV (``pd.DataFrame(rows).to_csv(index=False)``:
    the keys of the first row as the header, floats as ``repr``)."""
    header = list(dict.fromkeys(k for r in rows for k in r))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        for r in rows:
            w.writerow(["" if r.get(k) is None else repr(r[k]) if isinstance(r[k], float) else r[k] for k in header])


@main.command("compute-mmd")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--group-column", required=True)
@click.option("--permutations", default=500)
@click.option("--output", default=None, type=click.Path())
def compute_mmd(embeddings: str, group_column: str, permutations: int, output: str | None) -> None:
    """Pairwise MMD across all groups of ``group-column``."""
    from viscy_tpu_torch.evaluation.mmd import mmd_permutation_test

    ds = _load(embeddings)
    col = np.asarray([str(v) for v in np.asarray(ds["index"][group_column]).tolist()])
    groups = sorted(set(col.tolist()))
    rows = []
    for i, a in enumerate(groups):
        for b in groups[i + 1:]:
            res = mmd_permutation_test(ds["features"][col == a], ds["features"][col == b],
                                       n_permutations=permutations, device=_device())
            rows.append({"group_a": a, "group_b": b, **res})
    if output:
        write_csv(output, rows)
    click.echo(json.dumps(rows, indent=2, default=float))


@main.command("train-mlp-embedder")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--label-column", required=True)
@click.option("--output", required=True, type=click.Path())
@click.option("--hidden-dims", default="256,128")
@click.option("--epochs", default=30)
@click.option("--lr", default=1e-3)
def train_mlp_embedder_cmd(embeddings, label_column, output, hidden_dims, epochs, lr):
    """Train a supervised MLP embedder on a label column."""
    from viscy_tpu_torch.apps.dynaclr.mlp_embedder import train_mlp_embedder

    ds = _load(embeddings)
    labels = np.asarray(ds["index"][label_column])
    labeled = notna(labels)
    _, metrics = train_mlp_embedder(ds["features"][labeled], labels[labeled],
                                    hidden_dims=tuple(int(d) for d in hidden_dims.split(",")), epochs=epochs, lr=lr,
                                    output_path=output, device=_device())
    click.echo(json.dumps({"val_acc": metrics["val_acc"]}, indent=2))


@main.command("apply-mlp-embedder")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--model", "model_path", required=True, type=click.Path())
@click.option("--key", default="MLP")
def apply_mlp_embedder_cmd(embeddings, model_path, key):
    """Write MLP-embedder representations (``obsm[key]``) into the store."""
    from viscy_tpu_torch.apps.dynaclr.mlp_embedder import apply_mlp_embedder
    from viscy_tpu_torch.evaluation.zarr_utils import append_to_embedding_dataset

    reps = apply_mlp_embedder(_load(embeddings)["features"], model_path, device=_device())
    append_to_embedding_dataset(embeddings, obsm={key: reps})
    click.echo(f"Wrote {key} {reps.shape} into {embeddings}")


@main.command("probe-classifiers")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--label-columns", required=True, help="comma-separated")
@click.option("--splits", default=5)
def probe_classifiers(embeddings, label_columns, splits):
    """Cross-validated linear probes over several label columns."""
    from viscy_tpu_torch.evaluation.linear_classifier import cross_validate_classifier

    ds = _load(embeddings)
    results = {}
    for col in label_columns.split(","):
        labels = np.asarray(ds["index"][col])
        mask = notna(labels)
        results[col] = cross_validate_classifier(ds["features"][mask], labels[mask], n_splits=splits,
                                                 device=_device())
    click.echo(json.dumps(results, indent=2, default=float))


@main.command("combined-dim-reduction")
@click.option("--embeddings", "embedding_dirs", multiple=True, required=True, type=click.Path(exists=True))
@click.option("--method", default="pca", type=click.Choice(["pca", "umap", "phate"]))
@click.option("--components", default=8)
def combined_dim_reduction(embedding_dirs, method, components):
    """One PCA over the union of stores, each store's projection written
    back (``obsm["PCA"]``); ``umap`` and ``phate`` are refused, as in JAX."""
    from viscy_tpu_torch.evaluation._ops import host, on, resolve_device
    from viscy_tpu_torch.evaluation.dimensionality_reduction import pca_fit
    from viscy_tpu_torch.evaluation.zarr_utils import append_to_embedding_dataset

    if method != "pca":
        raise click.ClickException(f"combined-dim-reduction supports pca only ({method} is refused, as in JAX)")
    dev = resolve_device(_device())
    datasets = [_load(d) for d in embedding_dirs]
    combined = on(np.concatenate([ds["features"] for ds in datasets]), dev)
    n = min(components, min(combined.shape) - 1)
    _, _, comps, mean = pca_fit(combined, n)
    for d, ds in zip(embedding_dirs, datasets):
        proj = host((on(ds["features"], dev) - mean) @ comps.T).astype(np.float32)
        append_to_embedding_dataset(d, obsm={"PCA": proj})
        click.echo(f"{d}: PCA ({n}) written")


@main.command("append-annotations")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--csv", "csv_path", required=True, type=click.Path(exists=True))
@click.option("--columns", default=None, help="comma-separated task columns; default = all non-key columns")
@click.option("--spatial-tolerance", default=4.0)
def append_annotations_cmd(embeddings, csv_path, columns, spatial_tolerance):
    """Join annotation task columns onto the index by (fov_name, t,
    track_id) or (fov_name, id), mitosis duplicates resolved spatially."""
    from viscy_tpu_torch.data._tracks import _csv_columns
    from viscy_tpu_torch.evaluation.annotation import load_annotation
    from viscy_tpu_torch.evaluation.zarr_utils import append_to_embedding_dataset

    ds = _load(embeddings)
    join_keys = {"fov_name", "t", "track_id", "id", "y", "x"}
    tasks = columns.split(",") if columns else [c for c in _csv_columns(Path(csv_path))[0] if c not in join_keys]
    counts = {}
    for task in tasks:
        counts[task] = int(notna(load_annotation(ds, csv_path, task, spatial_tolerance=spatial_tolerance)).sum())
    append_to_embedding_dataset(embeddings, obs=ds.obs)
    click.echo(json.dumps(counts, indent=2))


@main.command("append-predictions")
@click.option("--embeddings", required=True, type=click.Path(exists=True))
@click.option("--classifier", required=True, type=click.Path(exists=True))
@click.option("--task", default="state")
@click.option("--features-key", default="features")
def append_predictions_cmd(embeddings, classifier, task, features_key):
    """Apply a saved probe to every cell and persist ``predicted_{task}``."""
    from viscy_tpu_torch.evaluation.linear_classifier import LinearClassifierPipeline
    from viscy_tpu_torch.evaluation.zarr_utils import append_to_embedding_dataset

    ds = _load(embeddings)
    pipeline = LinearClassifierPipeline.load(classifier, device=_device())
    ds["index"][f"predicted_{task}"] = pipeline.predict(ds[features_key])
    append_to_embedding_dataset(embeddings, obs=ds.obs)
    click.echo(f"Wrote predicted_{task} for {len(ds['index'])} cells")


@main.command("evaluate-smoothness")
@click.option("--config", "-c", "config_path", required=True, type=click.Path(exists=True))
def evaluate_smoothness_cmd(config_path: str) -> None:
    """Config-driven temporal smoothness across models: per-group CSVs and
    the markdown comparison."""
    from viscy_tpu_torch.apps.dynaclr.smoothness_benchmark import (
        SmoothnessEvalConfig,
        evaluate_smoothness,
        format_comparison_summary,
    )
    from viscy_tpu_torch.training.cli_utils import format_markdown_table, load_config

    raw = load_config(config_path)
    cfg = SmoothnessEvalConfig(**raw.pop("evaluation", {}), models=raw.get("models", []))
    results = evaluate_smoothness(cfg, device=_device())
    if not results:
        click.echo("No models were successfully processed.", err=True)
        return
    columns = ["smoothness_score", "dynamic_range", "adjacent_frame_mean", "adjacent_frame_peak",
               "random_frame_mean", "random_frame_peak"]
    rows = [{"model": label, **{c: metrics.get(c) for c in columns}} for label, metrics in results.items()]
    click.echo(format_markdown_table(rows, title="Temporal smoothness evaluation"))
    click.echo(format_comparison_summary(results, "smoothness_score", lower_is_better=True))
    click.echo(format_comparison_summary(results, "dynamic_range", lower_is_better=False))
    click.echo(f"Results saved to: {cfg.output_dir}")


@main.command("compare-models")
@click.option("--embeddings", "embedding_dirs", multiple=True, type=click.Path(exists=True))
@click.option("--config", "-c", "config_path", default=None, type=click.Path(exists=True),
              help="compare previously saved result CSVs")
@click.option("--distance-metric", default="cosine")
@click.option("--output", default=None, type=click.Path())
def compare_models(embedding_dirs, config_path, distance_metric, output):
    """Model comparison: live smoothness over embedding stores
    (``--embeddings``) or saved result files (``-c``)."""
    from viscy_tpu_torch.training.cli_utils import format_markdown_table, load_config

    if config_path is not None:
        from viscy_tpu_torch.apps.dynaclr.smoothness_benchmark import (
            CompareModelsConfig,
            compare_result_files,
            pipe_table,
        )

        raw = load_config(config_path)
        cfg = CompareModelsConfig(result_files=raw.get("result_files", []), **raw.get("comparison", {}))
        labels, metrics, table = compare_result_files(cfg)
        if not labels:
            click.echo("No valid result files were loaded", err=True)
            return
        click.echo("Model comparison")
        click.echo(pipe_table("model", labels, metrics, table))
        if cfg.output_path:
            click.echo(f"Results saved to: {cfg.output_path}")
        return
    if not embedding_dirs:
        raise click.UsageError("pass --embeddings stores or a -c results config")
    from viscy_tpu_torch.evaluation.smoothness import compute_embeddings_smoothness

    rows = []
    for d in embedding_dirs:
        ds = _load(d)
        res = compute_embeddings_smoothness(ds["features"], _index_with_fov_name(ds), distance_metric,
                                            device=_device())
        rows.append({"model": Path(d).name, **{k: v for k, v in res.items() if isinstance(v, (int, float))}})
    table = format_markdown_table(rows, title="Model comparison")
    if output:
        Path(output).write_text(table)
    click.echo(table)


@main.command("inspect-batches")
@click.option("--config", "-c", required=True, type=click.Path(exists=True))
@click.option("--num-batches", default=2)
def inspect_batches(config, num_batches):
    """Instantiate the config's datamodule and print each batch's shapes
    and dtypes."""
    from viscy_tpu_torch.training.cli_utils import load_config, to_numpy
    from viscy_tpu_torch.training.instantiate import instantiate

    dm = instantiate(load_config(config)["data"])
    dm.prepare_data()
    dm.setup("fit")
    for i, batch in enumerate(dm.train_dataloader()):
        if i >= num_batches:
            break
        desc = {k: (list(np.shape(v)), str(to_numpy(v).dtype)) for k, v in batch.items() if hasattr(v, "shape")}
        click.echo(json.dumps({"batch": i, **desc}, default=str))


@main.command("prepare-eval-configs")
@click.option("--config", "-c", required=True, type=click.Path(exists=True))
def prepare_eval_configs(config):
    """Per-step evaluation configs and a JSON manifest."""
    from viscy_tpu_torch.apps.dynaclr.evaluate_pipeline import prepare_configs

    click.echo(json.dumps(prepare_configs(config), indent=2))


@main.command("check-evals")
@click.option("--output-dir", "output_dirs", multiple=True, required=True, type=click.Path())
def check_evals(output_dirs):
    """Which per-step artifacts exist, per evaluation output directory."""
    from viscy_tpu_torch.apps.dynaclr.evaluate_pipeline import check_evals as check

    click.echo(json.dumps(check(output_dirs), indent=2))


@main.command("mmd-analysis")
@click.option("--config", "-c", required=True, type=click.Path(exists=True))
@click.option("--mode", default="per_experiment", type=click.Choice(["per_experiment", "combined", "pooled"]))
def mmd_analysis_cmd(config: str, mode: str) -> None:
    """The MMD perturbation-effect suite: per-experiment comparisons,
    cross-experiment batch effects, or the pooled analysis."""
    import yaml

    from viscy_tpu_torch.apps.dynaclr.mmd_suite import run_mode
    from viscy_tpu_torch.training.cli_utils import rows_to_csv

    with open(config) as f:
        raw = yaml.safe_load(f)
    cfg, rows = run_mode(raw, mode, device=_device())
    out_dir = Path(cfg.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / f"mmd_{mode}.csv"
    csv_path.write_text(rows_to_csv(rows))
    click.echo(f"wrote {len(rows)} rows to {csv_path}")


# subcommands of later slices: each raises with its name and what it waits for (ROADMAP.md Queue 1)
WAITING = {
    "apply-classifier": "a parquet writer (it writes its predictions as parquet)",
    "apply-linear-classifier": "a parquet writer (it writes its predictions as parquet)",
    "build-cell-index": "a parquet reader and writer (the cell index is parquet)",
    "preprocess-cell-index": "a parquet reader and writer (the cell index is parquet)",
    "convert-ops-parquet": "a parquet reader and writer",
    "plot-embeddings": "plot_embeddings.py (a pydantic config; matplotlib, absent on the card's machine)",
    "visualize-embeddings": "evaluation/visualization.py (matplotlib, absent on the card's machine)",
    "plot-mmd-heatmap": "evaluation/visualization.py (matplotlib, absent on the card's machine)",
    "run-linear-classifiers": "linear_classifiers/* (and linear_classifier.py:104-233)",
    "cross-validate-datasets": "linear_classifiers/* (and linear_classifier.py:104-233)",
    "build-pseudotime-template": "pseudotime/* (with host kernel H2)",
    "align-pseudotime": "pseudotime/* (with host kernel H2)",
    "evaluate-pseudotime": "pseudotime/* (with host kernel H2)",
}


def _refuse(name: str) -> None:
    raise NotImplementedError(f"dynaclr {name} is not ported to viscy_tpu_torch yet: it waits for {WAITING[name]} "
                              "(ROADMAP.md Queue 1)")


def _waiting(name: str):
    @main.command(name, context_settings={"ignore_unknown_options": True, "allow_extra_args": True},
                  help=f"Not ported yet: waits for {WAITING[name]}.")
    def _cmd():
        _refuse(name)

    return _cmd


for _name in WAITING:
    _waiting(_name)

main.add_command(main.commands["train-classifier"], name="train-linear-classifier")


if __name__ == "__main__":
    main()
