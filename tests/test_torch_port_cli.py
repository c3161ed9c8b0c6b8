"""The port's CLI and config loading against viscy_tpu's, and ``viscy-torch
fit`` / ``predict`` end to end on the CPU.

Config composition equals the JAX loader's on every file in ``configs/``;
every ``class_path`` of the VSCyto3D fit and predict configs resolves to a
port class without importing viscy_tpu. On a tiny synthetic plate and a
narrow FCMAE with ``trainer: {device: cpu}``: ``preprocess`` writes the
statistics, ``fit`` writes ``last``, ``metrics.csv`` and ``hparams.yaml``
(whose model wins over the config's when a fit resumes), ``predict`` from
``last`` writes a store equal, bit for bit, to the port's direct
``Trainer.predict`` plus the numpy ``blend_in`` assembly.
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from viscy_tpu.training.compose import load_composed_config as j_load
from viscy_tpu_torch.apps.cytoland.engine import VSUNet
from viscy_tpu_torch.data.hcs import HCSDataModule
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.callbacks.prediction_writer import blend_in
from viscy_tpu_torch.training.compose import load_composed_config
from viscy_tpu_torch.training.instantiate import resolve_class
from viscy_tpu_torch.training.trainer import Trainer
from viscy_tpu_torch.transforms import NormalizeSampled
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").rglob("*.yml"))
CHANNELS = ["Phase3D", "Nucleus", "Membrane"]
NARROW = dict(in_channels=1, out_channels=2, encoder_blocks=[1, 1, 2, 1], encoder_drop_path_rate=0.1,
              dims=[16, 32, 64, 128], decoder_conv_blocks=2, stem_kernel_size=[5, 2, 2], in_stack_depth=5,
              pretraining=False)


@pytest.mark.parametrize("path", CONFIGS, ids=[str(p.relative_to(ROOT / "configs")) for p in CONFIGS])
def test_composed_config_equals_jax(path):
    assert load_composed_config(path) == j_load(path)


def _class_paths(node):
    if isinstance(node, dict):
        if "class_path" in node:
            yield node["class_path"]
        for v in node.values():
            yield from _class_paths(v)
    elif isinstance(node, list):
        for v in node:
            yield from _class_paths(v)


@pytest.mark.parametrize("name", ["vscyto3d_fit.yml", "vscyto3d_predict.yml"])
def test_every_class_path_resolves_to_a_port_class(name):
    paths = list(_class_paths(load_composed_config(ROOT / "configs" / name)))
    assert len(paths) >= (9 if "fit" in name else 4)
    for p in paths:
        assert resolve_class(p).__module__.startswith("viscy_tpu_torch."), p
    # DynaCLR's engine, triplet datamodule and embedding writer are ported
    assert resolve_class("dynaclr.engine.ContrastiveModule").__module__ == "viscy_tpu_torch.apps.dynaclr.engine"
    assert resolve_class("viscy_data.TripletDataModule").__module__ == "viscy_tpu_torch.data.triplet"
    assert (resolve_class("viscy_utils.callbacks.EmbeddingWriter").__module__
            == "viscy_tpu_torch.training.callbacks.embedding_writer")


def test_the_port_resolves_configs_without_importing_viscy_tpu():
    code = (
        "import sys; from viscy_tpu_torch.training.cli import run_subcommand; "
        "from viscy_tpu_torch.training.instantiate import resolve_class; "
        "from viscy_tpu_torch.training.compose import load_composed_config as L; "
        f"[resolve_class(c) for c in {sorted(set(_class_paths(load_composed_config(ROOT / 'configs/vscyto3d_fit.yml'))))}]; "
        # the legacy U-Nets, the GAN and the VAEs (their engines, models and bridges)
        "[resolve_class(c) for c in ('cytoland.engine.VSUNet', 'dynacell.engine.DynacellGAN', "
        "'dynaclr.vae_engine.BetaVaeModule', 'viscy_models.vae.BetaVae25D', "
        "'viscy_models.vae.beta_vae_monai.BetaVaeMonai', 'viscy_models.gan.MultiScalePatchGAN3D')]; "
        "import viscy_tpu_torch.models.unet.unet2d, viscy_tpu_torch.models.unet.unet25d, "
        "viscy_tpu_torch.models.gan.losses, viscy_tpu_torch.models.schedule, viscy_tpu_torch.training.convert; "
        # data parallelism: the process group, the collectives and the sharded sampler
        "import viscy_tpu_torch.parallel.distributed, viscy_tpu_torch.parallel.mesh, "
        "viscy_tpu_torch.data.distributed; "
        # QC, TTA prediction, the segmentation test stage and the callbacks: no pydantic, no sklearn either
        "import viscy_tpu_torch.apps.qc, viscy_tpu_torch.apps.qc.cli, viscy_tpu_torch.apps.airtable_utils, "
        "viscy_tpu_torch.apps.cytoland.prediction, viscy_tpu_torch.apps.cytoland.evaluation, "
        "viscy_tpu_torch.data.segmentation, viscy_tpu_torch.evaluation.clustering, "
        "viscy_tpu_torch.training.log_images, viscy_tpu_torch.training.callbacks.embedding_snapshot, "
        "viscy_tpu_torch.training.callbacks.online_eval; "
        "[resolve_class(c) for c in ('viscy_utils.callbacks.EmbeddingSnapshotCallback', "
        "'viscy_utils.callbacks.OnlineEvalCallback', 'cytoland.evaluation.SegmentationMetrics2D', "
        "'viscy_data.segmentation.SegmentationDataModule')]; "
        # DynaCLR's evaluation: the evaluation library, the MLP embedder, tracking and the dynaclr CLI
        "import viscy_tpu_torch.evaluation._ops, viscy_tpu_torch.evaluation.zarr_utils, "
        "viscy_tpu_torch.evaluation.dimensionality_reduction, viscy_tpu_torch.evaluation.umap_native, "
        "viscy_tpu_torch.evaluation.phate_native, viscy_tpu_torch.evaluation.distance, "
        "viscy_tpu_torch.evaluation.embedding_map, viscy_tpu_torch.evaluation.smoothness, "
        "viscy_tpu_torch.evaluation.mmd, viscy_tpu_torch.evaluation.linear_classifier, "
        "viscy_tpu_torch.evaluation.lca, viscy_tpu_torch.evaluation.annotation, "
        "viscy_tpu_torch.apps.dynaclr.mlp_embedder, viscy_tpu_torch.apps.dynaclr.tracking, "
        "viscy_tpu_torch.apps.dynaclr.cli; "
        # the CTC tracking benchmark, the config-driven DynaCLR suites and the CLI helpers
        "import viscy_tpu_torch.training.cli_utils, viscy_tpu_torch.data.tiff, "
        "viscy_tpu_torch.apps.dynaclr.tracking_benchmark, viscy_tpu_torch.apps.dynaclr.tracking_benchmark.config, "
        "viscy_tpu_torch.apps.dynaclr.tracking_benchmark.graph, viscy_tpu_torch.apps.dynaclr.tracking_benchmark.solver, "
        "viscy_tpu_torch.apps.dynaclr.tracking_benchmark.ctc, viscy_tpu_torch.apps.dynaclr.tracking_benchmark.embedding, "
        "viscy_tpu_torch.apps.dynaclr.tracking_benchmark.metrics, "
        "viscy_tpu_torch.apps.dynaclr.tracking_benchmark.evaluate, "
        "viscy_tpu_torch.apps.dynaclr.tracking_benchmark.synthetic, viscy_tpu_torch.apps.dynaclr.smoothness_benchmark, "
        "viscy_tpu_torch.apps.dynaclr.mmd_suite, viscy_tpu_torch.apps.dynaclr.evaluate_pipeline; "
        # the linear-classifier pipelines and the DTW pseudotime package
        "import viscy_tpu_torch.apps.dynaclr.linear_classifiers, "
        "viscy_tpu_torch.apps.dynaclr.linear_classifiers.utils, "
        "viscy_tpu_torch.apps.dynaclr.linear_classifiers.orchestrated, "
        "viscy_tpu_torch.apps.dynaclr.linear_classifiers.cross_validation, "
        "viscy_tpu_torch.apps.dynaclr.pseudotime, viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_core, "
        "viscy_tpu_torch.apps.dynaclr.pseudotime.alignment, viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_alignment, "
        "viscy_tpu_torch.apps.dynaclr.pseudotime.io, viscy_tpu_torch.apps.dynaclr.pseudotime.signals, "
        "viscy_tpu_torch.apps.dynaclr.pseudotime.metrics, viscy_tpu_torch.apps.dynaclr.pseudotime.evaluation, "
        "viscy_tpu_torch.apps.dynaclr.pseudotime._legacy, viscy_tpu_torch.apps.dynaclr.pseudotime._tables; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'viscy_tpu', 'tensorstore', "
        "'pydantic', 'sklearn', 'pandas', 'imageio', 'PIL')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("sub", ["convert_to_anndata"])
def test_unported_subcommands_raise_with_their_name(tmp_path, sub):
    """Every subcommand is ported now; ``convert_to_anndata`` still refuses
    by name what it cannot do: a config without its paths, and the legacy
    embedding layout (``index.parquet``, no parquet reader)."""
    cfg = tmp_path / "c.yml"
    cfg.write_text("trainer: {device: cpu}\n")
    with pytest.raises(KeyError, match="embeddings_path"):
        cli.main([sub, "-c", str(cfg)])
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    (legacy / "index.parquet").write_bytes(b"")
    cfg = tmp_path / "convert.yml"
    cfg.write_text(f"convert: {{embeddings_path: {legacy}, output_path: {tmp_path / 'out.zarr'}}}\n")
    with pytest.raises(NotImplementedError, match="index.parquet"):
        cli.main([sub, "-c", str(cfg)])


def test_unsupported_trainer_keys_are_dropped_and_loggers_refused(caplog, monkeypatch):
    """Unsupported keys are dropped with a warning; ``logger`` is no longer
    refused: it maps to the metric sinks (TensorBoard built in, W&B only
    with the package and credentials, else a log line)."""
    with caplog.at_level(logging.WARNING, logger="viscy_tpu_torch"):
        trainer = cli.build_trainer({"device": "cpu", "max_epochs": 2, "precision": "bf16-mixed", "devices": 4,
                                     "default_root_dir": "unused"})
    assert trainer.max_epochs == 2
    assert "'precision'" in caplog.text and "devices" not in caplog.text
    assert trainer.logger.use_tensorboard and trainer.logger.extra == []
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    monkeypatch.delenv("WANDB_MODE", raising=False)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="viscy_tpu_torch"):
        trainer = cli.build_trainer({"device": "cpu", "default_root_dir": "unused",
                                     "logger": [{"class_path": "lightning.pytorch.loggers.WandbLogger"},
                                                {"class_path": "lightning.pytorch.loggers.TensorBoardLogger"}]})
    assert trainer.logger.extra == [] and "wandb is unavailable" in caplog.text


def _aug(patch, z):
    return [
        {"class_path": "viscy_tpu.data.host_transforms.HostRandWeightedCropd",
         "init_args": {"keys": CHANNELS + ["weight"], "w_key": "weight", "spatial_size": [z, patch, patch],
                       "num_samples": 2}},
        {"class_path": "viscy_transforms.BatchedRandFlipd", "init_args": {"keys": ["source", "target"], "prob": 0.5}},
        {"class_path": "viscy_transforms.BatchedRandAffined",
         "init_args": {"keys": ["source", "target"], "prob": 0.5, "rotate_range": [3.14, 0.0, 0.0],
                       "scale_range": [[1.0, 1.3], [0.75, 1.3], [0.75, 1.3]]}},
        {"class_path": "viscy_transforms.BatchedRandAdjustContrastd",
         "init_args": {"keys": ["source"], "gamma": [0.8, 1.2], "prob": 0.3}},
    ]


def _write(path: Path, cfg: dict) -> str:
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_preprocess_fit_and_predict_end_to_end_on_the_cpu(tmp_path):
    plate = build_hcs_plate(tmp_path / "plate.zarr", CHANNELS, zyx_shape=(6, 48, 48), num_timepoints=1,
                            rows=("A",), cols=("1",), fovs=("0", "1", "2"), seed=5)
    assert cli.main(["preprocess", "-c", _write(tmp_path / "pp.yml", {"data_path": str(plate),
                                                                      "num_workers": 2})]) is None
    stats = open_ome_zarr(plate)["A/1/0"].zattrs["normalization"]["Phase3D"]["fov_statistics"]
    assert 0.4 < stats["mean"] < 0.6
    model = {"class_path": "cytoland.engine.VSUNet",
             "init_args": {"architecture": "fcmae", "model_config": NARROW, "lr": 2e-4,
                           "schedule": "WarmupCosine", "warmup_steps": 1,
                           "loss_function": {"class_path": "viscy_utils.losses.MixedLoss",
                                             "init_args": {"l1_alpha": 0.5, "l2_alpha": 0.0, "ms_dssim_alpha": 0.5}}}}
    norm = {"class_path": "viscy_transforms.NormalizeSampled",
            "init_args": {"keys": CHANNELS, "level": "fov_statistics"}}
    data = {"data_path": str(plate), "source_channel": "Phase3D", "target_channel": ["Nucleus", "Membrane"],
            "z_window_size": 5, "split_ratio": 0.67, "batch_size": 4, "num_workers": 0, "yx_patch_size": [32, 32],
            "normalizations": [norm], "augmentations": _aug(32, 5)}
    root = tmp_path / "run"
    fit_cfg = {"base": [str(ROOT / "configs/recipes/trainer/fit.yml")], "model": model,
               "data": {"class_path": "viscy_data.HCSDataModule", "init_args": data},
               "trainer": {"device": "cpu", "max_epochs": 1, "default_root_dir": str(root), "log_every_n_steps": 1,
                           "limit_train_batches": 2, "limit_val_batches": 1}}
    trainer = cli.main(["fit", "-c", _write(tmp_path / "fit.yml", fit_cfg)])
    assert trainer.global_step == 1 and trainer.feed_stats["steps"] == 1  # one widened window per FOV
    assert (root / "checkpoints" / "last").is_symlink()
    lines = [json.loads(s) for s in (root / "metrics.csv").read_text().splitlines()]
    assert any("loss/validate" in x for x in lines) and all(np.isfinite(list(x.values())).all() for x in lines)
    assert yaml.safe_load((root / "hparams.yaml").read_text()) == load_composed_config(tmp_path / "fit.yml")["model"]
    # resuming a fit, the checkpoint's hparams win over the config's model
    other = dict(model, init_args=dict(model["init_args"], model_config=dict(NARROW, dims=[8, 16, 32, 64])))
    resumed = cli.main(["fit", "-c", _write(tmp_path / "resume.yml", dict(fit_cfg, model=other,
                        trainer=dict(fit_cfg["trainer"], max_epochs=2))), "--ckpt_path", str(root / "checkpoints" / "last")])
    assert resumed.global_step == 2 and resumed.current_epoch == 1

    pred_model = {"class_path": "cytoland.engine.VSUNet",
                  "init_args": {"architecture": "fcmae", "model_config": dict(NARROW, encoder_drop_path_rate=0.0)}}
    pred_norm = {"class_path": "viscy_transforms.NormalizeSampled",
                 "init_args": {"keys": ["Phase3D"], "level": "fov_statistics"}}
    pred_data = {"data_path": str(plate), "source_channel": "Phase3D", "target_channel": ["Nucleus", "Membrane"],
                 "z_window_size": 5, "batch_size": 2, "num_workers": 0, "normalizations": [pred_norm]}
    store = tmp_path / "pred.zarr"
    pred_cfg = {"model": pred_model, "data": {"class_path": "viscy_data.HCSDataModule", "init_args": pred_data},
                "trainer": {"device": "cpu", "callbacks": [
                    {"class_path": "viscy_utils.callbacks.HCSPredictionWriter",
                     "init_args": {"output_store": str(store)}}]},
                "ckpt_path": str(root / "checkpoints" / "last")}
    cli.main(["predict", "-c", _write(tmp_path / "predict.yml", pred_cfg)])

    # the same prediction directly: Trainer.predict, then the numpy blend
    module = VSUNet("fcmae", dict(NARROW, encoder_drop_path_rate=0.0), device="cpu")
    dm = HCSDataModule(plate, "Phase3D", ["Nucleus", "Membrane"], 5, batch_size=2, num_workers=0,
                       normalizations=[NormalizeSampled(keys=["Phase3D"], level="fov_statistics")])
    preds = Trainer(device="cpu", default_root_dir=tmp_path / "direct").predict(
        module, dm, ckpt_path=root / "checkpoints" / "last", return_predictions=True)
    dm.setup("predict")
    want = {}
    for batch, pred in zip(dm.predict_dataloader(), preds):
        for (img, t, z), p in zip(batch["index"], pred.numpy()):
            buf = want.setdefault("/".join(img.strip("/").split("/")[:3]), np.zeros((2, 6, 48, 48), np.float32))
            buf[:, z : z + 5] = blend_in(buf[:, z : z + 5], p, slice(z, z + 5))
    out = open_ome_zarr(store)
    assert out.channel_names == ["Nucleus", "Membrane"] and sorted(want) == [n for n, _ in out.positions()]
    for fov, w in want.items():
        got = out[fov]["0"]
        assert got.shape == (1, 2, 6, 48, 48)
        np.testing.assert_array_equal(got[0], w)
    assert torch.isfinite(torch.from_numpy(got[0])).all()
