"""``viscy-torch`` CLI (counterpart of ``viscy_tpu/training/cli.py``).

Subcommands ``fit``, ``validate``, ``test``, ``predict``, ``preprocess``,
``precompute``, ``export`` and ``convert_to_anndata``, each with
``--config`` / ``-c`` and
``--ckpt_path``; the configs are the JAX package's (LightningCLI-style
``model:`` / ``data:`` / ``trainer:`` with ``class_path`` / ``init_args``
and ``base:`` recipes), their class paths remapped to this package; a
``trainer.logger`` maps to the metric sinks (TensorBoard is built in, W&B
when the package and credentials are there). Entry points run on the card;
``trainer: {device: cpu}`` runs a config on the CPU (the model is built
there too). ``convert_to_anndata`` reads ``embeddings_path`` and
``output_path`` from the config's ``convert:`` block (or its top level).

Run as ``viscy-torch fit -c config.yml`` or
``python -m viscy_tpu_torch.training.cli fit -c config.yml``; in a
program, ``main(["fit", "-c", path])`` returns the Trainer.

Several processes (data parallelism): start one per card with the
environment of :mod:`viscy_tpu_torch.parallel.distributed`
(``VISCY_COORDINATOR`` / ``VISCY_NUM_PROCESSES`` / ``VISCY_PROCESS_ID``,
or torchrun's); the process group starts before the model is built, so the
model lands on the process's card, and only rank 0 writes
``hparams.yaml`` and an export.
"""

from __future__ import annotations

import inspect
import logging
import os
from datetime import datetime
from pathlib import Path

import click
import yaml

from viscy_tpu_torch.parallel.distributed import is_rank_zero, maybe_initialize
from viscy_tpu_torch.training.compose import load_composed_config
from viscy_tpu_torch.training.instantiate import instantiate, resolve_class

_logger = logging.getLogger("viscy_tpu_torch")

# Lightning trainer keys with no meaning here (the process count comes from the
# launch environment: viscy_tpu_torch.parallel.distributed)
_IGNORED_TRAINER_KEYS = {
    "strategy",
    "devices",
    "accelerator",
    "num_nodes",
    "use_distributed_sampler",
    "sync_batchnorm",
    "num_sanity_val_steps",
    "enable_progress_bar",
    "enable_model_summary",
    "deterministic",
    "benchmark",
    "detect_anomaly",
    "inference_mode",
    "plugins",
    "profiler",
    "reload_dataloaders_every_n_epochs",
}


def _trainer_arg_keys() -> set[str]:
    from viscy_tpu_torch.training.trainer import Trainer

    return {k for k in inspect.signature(Trainer.__init__).parameters if k not in ("self", "callbacks", "loggers")}


def build_trainer(trainer_cfg: dict, subcommand: str | None = None):
    """A Trainer from a Lightning-style trainer config; ``logger`` maps to
    extra metric sinks (:func:`~viscy_tpu_torch.training.loggers.build_loggers_from_config`),
    keys the trainer does not take are dropped with a warning."""
    from viscy_tpu_torch.training.loggers import build_loggers_from_config
    from viscy_tpu_torch.training.trainer import Trainer

    trainer_cfg = dict(trainer_cfg or {})
    callbacks = instantiate(trainer_cfg.pop("callbacks", []) or [])
    logger_cfg = trainer_cfg.pop("logger", None)
    # metric sinks live on rank 0 only
    loggers = build_loggers_from_config(logger_cfg, subcommand) if is_rank_zero() else []
    accepted = _trainer_arg_keys()
    for key in list(trainer_cfg):
        if key in _IGNORED_TRAINER_KEYS:
            trainer_cfg.pop(key)
        elif key not in accepted:
            _logger.warning(
                "trainer config key %r is not supported by this trainer and was dropped — "
                "training semantics may differ from the reference run.",
                key,
            )
            trainer_cfg.pop(key)
    default_root = trainer_cfg.pop("default_root_dir", None)
    if default_root is None:
        default_root = Path("lightning_logs") / datetime.now().strftime("%Y%m%d-%H%M%S")
    return Trainer(default_root_dir=default_root, callbacks=callbacks, loggers=loggers, **trainer_cfg)


def _hparams_file(ckpt_path: str | Path) -> Path:
    """``<root>/hparams.yaml`` beside ``<root>/checkpoints/<name>``."""
    p = Path(ckpt_path)
    if p.is_symlink():
        p = p.resolve()
    for parent in [p] + list(p.parents):
        if parent.name == "checkpoints":
            return parent.parent / "hparams.yaml"
    return p.parent / "hparams.yaml"


def _load_ckpt_hparams(ckpt_path: str | Path) -> dict | None:
    f = _hparams_file(ckpt_path)
    if not f.exists():
        _logger.info("no hparams.yaml found beside %s; config model hparams apply", ckpt_path)
        return None
    with open(f) as fh:
        saved = yaml.safe_load(fh)
    _logger.info("fit resume: model hparams restored from %s (ckpt wins over config)", f)
    return saved


def _save_ckpt_hparams(trainer, model_cfg: dict) -> None:
    out = Path(trainer.default_root_dir) / "hparams.yaml"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as fh:
        yaml.safe_dump(model_cfg, fh)


def _with_device(model_cfg: dict, device) -> dict:
    """Build the model where the trainer runs, unless the config says."""
    if device is None:
        return model_cfg
    model_cfg = dict(model_cfg)
    init_args = dict(model_cfg.get("init_args") or {})
    params = inspect.signature(resolve_class(model_cfg["class_path"]).__init__).parameters
    if "device" in params and "device" not in init_args:
        init_args["device"] = device
    model_cfg["init_args"] = init_args
    return model_cfg


def run_subcommand(subcommand: str, config_path: str, ckpt_path: str | None = None):
    """Run one subcommand on a config; returns the Trainer (``None`` for
    ``preprocess``, ``precompute`` and ``convert_to_anndata``)."""
    cfg = load_composed_config(config_path)
    cfg.pop("launcher", None)
    cfg.pop("benchmark", None)
    if subcommand == "preprocess":
        from viscy_tpu_torch.preprocess.stats import generate_fg_masks, generate_normalization_metadata

        pp = cfg.get("preprocess", cfg)
        data_path = pp["data_path"] if "data_path" in pp else pp["zarr_dir"]
        generate_normalization_metadata(
            data_path,
            num_workers=pp.get("num_workers", 4),
            channel_ids=pp.get("channel_ids", -1),
            grid_spacing=pp.get("grid_spacing", 32),
            compute_otsu=pp.get("compute_otsu", False),
        )
        if pp.get("fg_mask_channels"):
            generate_fg_masks(data_path, pp["fg_mask_channels"], fg_mask_key=pp.get("fg_mask_key", "fg_mask"))
        return None
    if subcommand == "precompute":
        from viscy_tpu_torch.preprocess.precompute import precompute_normalized

        pc = cfg.get("precompute", cfg)
        precompute_normalized(pc["data_path"], pc["output_path"], pc["channel_names"],
                              level=pc.get("level", "fov_statistics"))
        return None
    if subcommand == "convert_to_anndata":
        from viscy_tpu_torch.preprocess.precompute import convert_to_anndata

        cc = cfg.get("convert", cfg)
        convert_to_anndata(cc["embeddings_path"], cc["output_path"])
        return None
    if subcommand not in ("fit", "validate", "test", "predict", "export"):
        raise click.UsageError(f"Unknown subcommand {subcommand}")
    device = (cfg.get("trainer") or {}).get("device")
    # the process group (and each process's card) before any device use
    maybe_initialize(device=device or "cuda")
    ckpt = ckpt_path or cfg.get("ckpt_path")
    # on fit, the hparams saved with the checkpoint win over the config
    # (a resume restores the model it trained); elsewhere the config wins
    if subcommand == "fit" and ckpt and "model" in cfg:
        saved = _load_ckpt_hparams(ckpt)
        if saved is not None:
            cfg["model"] = saved
    model = instantiate(_with_device(cfg["model"], device)) if "model" in cfg else None
    datamodule = instantiate(cfg["data"]) if "data" in cfg else None
    trainer = build_trainer(cfg.get("trainer", {}), subcommand)
    if subcommand == "fit":
        if "model" in cfg and is_rank_zero():
            _save_ckpt_hparams(trainer, cfg["model"])
        trainer.fit(model, datamodule, ckpt_path=ckpt)
    elif subcommand == "validate":
        for k, v in sorted(trainer.validate(model, datamodule, ckpt_path=ckpt).items()):
            _logger.info(f"  {k}  {v:.6f}")
    elif subcommand == "test":
        trainer.test(model, datamodule, ckpt_path=ckpt)
    elif subcommand == "predict":
        trainer.predict(model, datamodule, ckpt_path=ckpt)
    elif is_rank_zero():
        from viscy_tpu_torch.training.export import export_model

        export_model(model, cfg.get("export", {}))
    return trainer


@click.group()
def cli() -> None:
    """viscy-torch: virtual staining on PyTorch and CUDA."""
    level = os.environ.get("VISCY_LOG_LEVEL", "INFO")
    logging.basicConfig(level=getattr(logging, level.upper(), logging.INFO))


def _register(name: str, help_text: str):
    @cli.command(name=name, help=help_text)
    @click.option("--config", "-c", required=True, type=click.Path(exists=True))
    @click.option("--ckpt_path", "--ckpt-path", default=None)
    def _cmd(config: str, ckpt_path: str | None):
        return run_subcommand(name, config, ckpt_path)

    return _cmd


fit = _register("fit", "Train a model.")
validate = _register("validate", "Run validation.")
test = _register("test", "Run the test stage.")
predict = _register("predict", "Run inference and write outputs.")
preprocess = _register("preprocess", "Compute normalization statistics.")
export = _register("export", "Export a trained model.")
precompute = _register("precompute", "Write normalized arrays to a new store.")
convert_to_anndata = _register("convert_to_anndata", "Convert an embedding store to an AnnData zarr store.")


def main(argv: list[str] | None = None):
    """The console entry point. With ``argv`` (in a program) errors
    propagate and the subcommand's result (the Trainer) is returned."""
    if argv is None:
        return cli.main(prog_name="viscy-torch")
    return cli.main(args=list(argv), prog_name="viscy-torch", standalone_mode=False)


if __name__ == "__main__":
    main()
