"""Extra metric sinks: the env-gated Weights & Biases logger (counterpart of
``viscy_tpu/training/loggers.py``).

Rebuilds the reference CLI's default-W&B behavior
(``viscy_utils/cli.py:35-92``): timestamped run names
(``YYYYMMDD-HHMMSS_<name>``), ``job_type`` = subcommand, group from the
``VISCY_WANDB_GROUP`` / ``VISCY_WANDB_LAUNCH`` env vars (else the base run
name). Without the ``wandb`` package or credentials the logger degrades to
a no-op with a log line, so reference configs that request the W&B logger
still run.
"""

from __future__ import annotations

import logging
import os
import re
from datetime import datetime

_logger = logging.getLogger("viscy_tpu_torch")

_RUN_NAME_PREFIX = re.compile(r"^\d{8}-\d{6}_")
_RUN_TIMESTAMP_FORMAT = r"%Y%m%d-%H%M%S"

__all__ = ["WandbLogger", "build_loggers_from_config", "prefix_run_name"]


def prefix_run_name(base_name: str, run_timestamp: str | None = None) -> str:
    """Timestamp a W&B run name unless it is already stamped
    (reference ``_prefix_wandb_run_name``, cli.py:28-32)."""
    if _RUN_NAME_PREFIX.match(base_name):
        return base_name
    if run_timestamp is None:
        run_timestamp = datetime.now().strftime(_RUN_TIMESTAMP_FORMAT)
    return f"{run_timestamp}_{base_name}"


def wandb_available() -> bool:
    """W&B activates only with the package installed AND credentials set."""
    if not (os.environ.get("WANDB_API_KEY") or os.environ.get("WANDB_MODE") == "offline"):
        return False
    try:
        import wandb  # noqa: F401

        return True
    except ImportError:
        return False


class WandbLogger:
    """Metric sink posting to Weights & Biases when available.

    Mirrors the reference naming convention (``viscy_utils/cli.py:35-69``):

    - run name: ``<timestamp>_<name or subcommand>``
    - ``job_type``: the CLI subcommand
    - ``group``: ``VISCY_WANDB_GROUP``/``VISCY_WANDB_LAUNCH`` env override,
      else the un-timestamped base name.
    """

    def __init__(
        self,
        name: str | None = None,
        project: str | None = None,
        group: str | None = None,
        job_type: str | None = None,
        save_dir: str | None = None,
        **init_args,
    ) -> None:
        self._run = None
        base_name = name or job_type or "run"
        group_override = os.getenv("VISCY_WANDB_GROUP") or os.getenv("VISCY_WANDB_LAUNCH")
        self.name = prefix_run_name(base_name)
        self.group = group_override or group or base_name
        self.job_type = job_type
        self.project = project
        self.save_dir = save_dir
        self.init_args = init_args
        if not wandb_available():
            _logger.info(
                "W&B logger requested but wandb is unavailable "
                "(package missing or WANDB_API_KEY unset): metrics go to "
                "CSV/TensorBoard only."
            )
            return
        import wandb

        self._run = wandb.init(
            name=self.name,
            project=project,
            group=self.group,
            job_type=job_type,
            dir=save_dir,
            **init_args,
        )

    @property
    def active(self) -> bool:
        return self._run is not None

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        if self._run is not None:
            self._run.log({k: float(v) for k, v in metrics.items()}, step=step)

    def log_image(self, tag: str, image, step: int) -> None:
        if self._run is not None:
            import wandb

            self._run.log({tag: wandb.Image(image)}, step=step)

    def log_hparams(self, hparams: dict) -> None:
        if self._run is not None:
            self._run.config.update(hparams, allow_val_change=True)

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()
            self._run = None


_WANDB_CLASS_PATHS = {
    "lightning.pytorch.loggers.WandbLogger",
    "lightning.pytorch.loggers.wandb.WandbLogger",
    "pytorch_lightning.loggers.WandbLogger",
    "viscy_tpu.training.loggers.WandbLogger",
}


def build_loggers_from_config(logger_cfg, subcommand: str | None = None) -> list:
    """Map a Lightning ``trainer.logger`` config to extra sinks.

    TensorBoard/CSV logger configs map to the built-in sinks (return []);
    W&B configs build a :class:`WandbLogger`. Like the reference default
    (``cli.py:88-92``), W&B is also attached by default when credentials
    are present even if the config names no logger.
    """
    cfgs = logger_cfg if isinstance(logger_cfg, list) else [logger_cfg]
    sinks: list = []
    saw_wandb = False
    for cfg in cfgs:
        if not isinstance(cfg, dict):
            continue
        class_path = cfg.get("class_path", "")
        if class_path in _WANDB_CLASS_PATHS or class_path.endswith("WandbLogger"):
            saw_wandb = True
            init_args = dict(cfg.get("init_args") or {})
            init_args.setdefault("job_type", subcommand)
            sinks.append(WandbLogger(**init_args))
    if not saw_wandb and wandb_available():
        sinks.append(WandbLogger(job_type=subcommand))
    return [s for s in sinks if getattr(s, "active", True)]
