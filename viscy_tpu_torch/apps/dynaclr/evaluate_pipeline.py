"""Evaluation-pipeline configs (counterpart of
``viscy_tpu/apps/dynaclr/evaluate_pipeline.py``; reference
``dynaclr/evaluation/evaluate.py`` ``prepare_configs``): one evaluation YAML
becomes a config per step and a JSON manifest, and ``check-evals`` reports
which steps' artifacts exist. The config validates without pydantic.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import yaml

from viscy_tpu_torch.apps.airtable_utils.schemas import REQUIRED, Model, as_int, as_str, list_of, optional

__all__ = ["EvaluationConfig", "prepare_configs", "check_evals"]

_STEP_SUBDIRS = {"smoothness": "smoothness", "mmd": "mmd", "plot": "plots", "linear_classifiers": "linear_classifiers"}


class EvaluationConfig(Model):
    """An evaluation run (JAX's fields and defaults)."""

    fields = (
        ("training_config", as_str, REQUIRED),
        ("output_dir", as_str, REQUIRED),
        ("steps", list_of(as_str), lambda: ["predict", "smoothness", "mmd", "linear_classifiers"]),
        ("ckpt_path", optional(as_str), None),
        ("cell_index_path", optional(as_str), None),
        ("label_columns", list_of(as_str), list),
        ("group_column", as_str, "perturbation"),
        ("mmd_permutations", as_int, 500),
        ("distance_metric", as_str, "cosine"),
    )


def prepare_configs(config_path: str | Path) -> dict:
    """Write each step's config under ``output_dir/configs`` and the
    manifest ``configs/manifest.json``; return the manifest."""
    from viscy_tpu_torch.training.cli_utils import load_config

    eval_cfg = EvaluationConfig(**load_config(config_path))
    training_cfg = load_config(eval_cfg.training_config)
    output_dir = Path(eval_cfg.output_dir)
    for sub in ["configs", "embeddings"] + [_STEP_SUBDIRS[s] for s in eval_cfg.steps if s in _STEP_SUBDIRS]:
        (output_dir / sub).mkdir(parents=True, exist_ok=True)
    shutil.copy(config_path, output_dir / "configs" / "eval.yaml")

    cell_index = eval_cfg.cell_index_path or (training_cfg.get("data", {}).get("init_args", {}).get("cell_index_path"))
    embeddings_dir = output_dir / "embeddings"
    manifest: dict = {"output_dir": str(output_dir), "embeddings_dir": str(embeddings_dir),
                      "cell_index_path": cell_index, "steps": list(eval_cfg.steps)}

    def _write(name: str, payload: dict) -> str:
        path = output_dir / "configs" / f"{name}.yaml"
        with open(path, "w") as f:
            yaml.safe_dump(payload, f, sort_keys=False)
        return str(path)

    for step in eval_cfg.steps:
        if step == "predict":
            predict_cfg = dict(training_cfg)
            predict_cfg.pop("trainer", None)
            predict_cfg["predict"] = {"ckpt_path": eval_cfg.ckpt_path, "output_path": str(embeddings_dir)}
            manifest["predict"] = _write("predict", predict_cfg)
        elif step == "smoothness":
            manifest["smoothness"] = _write("smoothness", {
                "embeddings": str(embeddings_dir), "distance_metric": eval_cfg.distance_metric,
                "output": str(output_dir / "smoothness" / "smoothness.json")})
        elif step == "mmd":
            manifest["mmd"] = _write("mmd", {
                "embeddings": str(embeddings_dir), "group_column": eval_cfg.group_column,
                "permutations": eval_cfg.mmd_permutations, "output": str(output_dir / "mmd" / "mmd.csv")})
        elif step == "linear_classifiers":
            manifest["linear_classifiers"] = _write("linear_classifiers", {
                "embeddings": str(embeddings_dir), "label_columns": list(eval_cfg.label_columns),
                "output_dir": str(output_dir / "linear_classifiers")})
    (output_dir / "configs" / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return manifest


def check_evals(output_dirs) -> dict:
    """Per output directory: whether the manifest and each step's artifact
    exist (``check-evals``)."""
    report = {}
    for d in map(Path, output_dirs):
        manifest_path = d / "configs" / "manifest.json"
        status = {"manifest": manifest_path.exists()}
        if manifest_path.exists():
            manifest = json.loads(manifest_path.read_text())
            emb = Path(manifest.get("embeddings_dir", d / "embeddings"))
            status["embeddings"] = (emb / "index.parquet").exists() or (emb / "obs").exists()
            status["smoothness"] = (d / "smoothness" / "smoothness.json").exists()
            status["mmd"] = (d / "mmd" / "mmd.csv").exists()
            lc = d / "linear_classifiers"
            status["linear_classifiers"] = any(lc.glob("*")) if lc.exists() else False
        report[str(d)] = status
    return report
