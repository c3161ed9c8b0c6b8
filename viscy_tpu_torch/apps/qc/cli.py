"""``qc`` command (counterpart of ``viscy_tpu/apps/qc/cli.py``):

    python -m viscy_tpu_torch.apps.qc.cli run -c qc_run.yml [--device cpu]

runs the configured metrics over every FOV (on the card unless
``--device cpu``) and writes the annotation metadata into the plate."""

from __future__ import annotations

import click
import yaml

from viscy_tpu_torch.apps.qc.config import QCConfig
from viscy_tpu_torch.apps.qc.qc_metrics import generate_qc_metadata


@click.group()
def main() -> None:
    """Quality-control metrics for HCS OME-Zarr datasets."""


@main.command()
@click.option("--config", "-c", required=True, type=click.Path(exists=True))
@click.option("--device", default="cuda", show_default=True, help="where the metrics compute: cuda or cpu")
def run(config: str, device: str) -> None:
    """Run configured QC metrics and annotate the dataset."""
    with open(config) as f:
        cfg = QCConfig(**yaml.safe_load(f))
    metrics = cfg.build_metrics(device=device)
    if metrics:
        generate_qc_metadata(cfg.data_path, metrics, num_workers=cfg.num_workers)
    if cfg.annotation is not None:
        from viscy_tpu_torch.apps.qc.annotation import write_annotation_metadata

        write_annotation_metadata(cfg.data_path, cfg.annotation)


if __name__ == "__main__":
    main()
