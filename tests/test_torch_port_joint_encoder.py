"""The port's cross-modal ``JointEncoderModule`` against
``viscy_tpu.apps.dynaclr.multi_modal`` on the CPU.

Weights and BatchNorm running statistics are numpy-seeded and reach the
port through ``joint_encoder_state_dict_from_flax``; the JAX references run
under ``jax.jit``. Tolerances (float32), the DynaCLR step's bound: both
embeddings and projections and every gradient within 2e-3 of the range
with Pearson r > 0.9999; the loss within 1e-5 relative; both BatchNorms'
running statistics after the step within 1e-6. The biases a train-mode
BatchNorm removes (and the head norm's, which the projection's first
BatchNorm removes) have a gradient of 0 up to rounding on both sides.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from viscy_tpu.apps.dynaclr import multi_modal as jmm
from viscy_tpu_torch.apps.dynaclr import multi_modal as tmm
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.convert import joint_encoder_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.training.instantiate import instantiate
from viscy_tpu_torch.training.trainer import Trainer
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_helpers import assert_rel_close, seeded_params

# one channel each, depth 10 so the stem's 2 slices fold into the first width (16)
TINY = dict(backbone="convnext_test", in_channels=1, in_stack_depth=10, stem_kernel_size=(5, 4, 4),
            stem_stride=(5, 4, 4), embedding_dim=32, projection_dim=16)
SHAPE = (4, 1, 10, 64, 64)
ENCODERS = ("source_encoder", "target_encoder")
# a shift a following train-mode normalization removes: gradient 0 up to rounding
SHIFTS = {f"{e}.{n}" for e in ENCODERS for n in ("encoder.head.norm.bias", "projection.0.bias", "projection.3.bias")}


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _x(seed):
    return np.random.default_rng(seed).random(SHAPE, np.float32)


def _jmodule(backbone: str):
    cfg = dict(TINY, backbone=backbone)
    return jmm.JointEncoderModule(source_encoder=dict(cfg), target_encoder=dict(cfg), temperature=0.2)


def _variables(jmod, seed: int) -> tuple[dict, dict]:
    """Seeded numpy ``params`` and ``batch_stats`` (means N(0, 0.1), variances
    U(0.5, 1.5)) of both encoders."""
    shapes = jax.eval_shape(lambda: jmod.model.init(jax.random.PRNGKey(0), jnp.zeros(SHAPE), jnp.zeros(SHAPE)))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.normal(0, 0.1, s.shape) if path[-1].key == "mean" else rng.uniform(0.5, 1.5, s.shape))
        .astype(np.float32), shapes["batch_stats"])
    return seeded_params(shapes["params"], seed), stats


def _tmodule(backbone: str, params, stats):
    cfg = dict(TINY, backbone=backbone)
    tmod = tmm.JointEncoderModule(source_encoder=dict(cfg), target_encoder=dict(cfg), temperature=0.2, device="cpu")
    load_flax_params(tmod.model, params, stats)
    return tmod


def _close(got: torch.Tensor, want) -> None:
    assert_rel_close(got.detach().numpy(), np.asarray(want), 2e-3, 0.9999)


def _assert_stats(model, jstats) -> None:
    want = joint_encoder_state_dict_from_flax({}, jax.tree_util.tree_map(np.asarray, jstats))
    state = model.state_dict()
    assert len(want) == 8 and all(k.endswith(("running_mean", "running_var")) for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-5, err_msg=k)


def test_bridge_maps_both_encoders_and_their_statistics():
    """Every parameter and running statistic of both encoders lands under
    ``source_encoder.`` / ``target_encoder.`` (all but the BatchNorms'
    ``num_batches_tracked``), and the two encoders' seeded weights differ."""
    jmod = _jmodule("convnextv2_test")
    params, stats = _variables(jmod, 3)
    bridged = joint_encoder_state_dict_from_flax(params, stats)
    tmod = _tmodule("convnextv2_test", params, stats)
    state = tmod.model.state_dict()
    assert set(state) - set(bridged) == {f"{e}.projection.{i}.num_batches_tracked" for e in ENCODERS for i in (1, 4)}
    for k, v in bridged.items():
        assert torch.equal(state[k], v), k
    fresh = tmm.JointEncoderModule(source_encoder=dict(TINY), target_encoder=dict(TINY), device="cpu").model
    assert not torch.equal(fresh.source_encoder.stem.conv.weight, fresh.target_encoder.stem.conv.weight)


@pytest.mark.parametrize("backbone", ["convnextv2_test", "convnext_test"])
def test_step_matches_jax(backbone):
    """One train-mode step: both embeddings and projections, the NT-Xent
    loss, every gradient and both BatchNorms' running statistics after it;
    then the validation loss and ``predict_step`` in eval mode."""
    jmod = _jmodule(backbone)
    params, stats = _variables(jmod, 7)
    batch = {"source": _x(8), "target": _x(9)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    outs, _ = jax.jit(lambda v: jmod.model.apply(v, jb["source"], jb["target"], train=True,
                                                 mutable=["batch_stats"]))(jvars)

    def loss_fn(p):
        value, (_, extra) = jmod.training_loss({"params": p, "batch_stats": jvars["batch_stats"]}, jb,
                                               jax.random.PRNGKey(0))
        return value, extra

    (want, extra), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jvars["params"])
    updated = {"params": jvars["params"], "batch_stats": extra["batch_stats"]}
    want_val = jax.jit(lambda v: jmod.validation_loss(v, jb, jax.random.PRNGKey(0))[0])(updated)
    want_pred = jax.jit(lambda v: jmod.predict_step(v, jb))(updated)

    tmod = _tmodule(backbone, params, stats).train()
    seen = {}
    for name in ENCODERS:
        getattr(tmod.model, name).register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tmod.training_loss(tb, torch.Generator())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for (emb, proj), (w_emb, w_proj) in zip((seen[n] for n in ENCODERS), outs):
        _close(emb, w_emb)
        _close(proj, w_proj)
    _assert_stats(tmod.model, extra["batch_stats"])
    want_g = joint_encoder_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {name: p.grad for name, p in tmod.model.named_parameters()}
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        if name in SHIFTS:
            scale = np.abs(grads[name.replace("bias", "weight")].numpy()).max()
            assert np.abs(g.numpy()).max() < 1e-5 * scale and np.abs(want_g[name].numpy()).max() < 1e-5 * scale
        else:
            assert_rel_close(g.numpy(), want_g[name].numpy(), 2e-3, 0.9999)

    tmod.eval()
    with torch.no_grad():
        np.testing.assert_allclose(float(tmod.validation_loss(tb)), float(want_val), rtol=1e-5)
        pred = tmod.predict_step(tb)
    assert set(pred) == {"features", "projections", "target_features", "target_projections"}
    for k, v in pred.items():
        _close(v, want_pred[k])


def test_optimizers_and_example_input_follow_jax():
    """``configure_optimizers``: AdamW at the module's lr, Constant or
    WarmupCosine as JAX's optax schedule; the example input follows each
    encoder's stem (or one explicit shape for both)."""
    from viscy_tpu.training.optimizers import configure_adamw_scheduler

    for schedule in ("Constant", "WarmupCosine"):
        tmod = tmm.JointEncoderModule(source_encoder=dict(TINY), target_encoder=dict(TINY, in_stack_depth=5,
                                      stem_kernel_size=(5, 4, 4)), lr=3e-4, schedule=schedule, device="cpu")
        opt, _, sched = tmod.configure_optimizers(200)
        _, jsched = configure_adamw_scheduler(lr=3e-4, schedule=schedule, total_steps=200)
        assert len(opt.param_groups[0]["params"]) == len(list(tmod.parameters()))
        for count in (0, 1, 2, 50, 199):
            np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=1e-5, atol=1e-10)  # optax: float32
    ex = tmod.example_input()
    jex = jmm.JointEncoderModule(source_encoder=dict(TINY), target_encoder=dict(TINY, in_stack_depth=5)).example_input()
    assert {k: v.shape for k, v in ex.items()} == {k: v.shape for k, v in jex.items()} == {
        "source": (1, 1, 10, 224, 224), "target": (1, 1, 5, 224, 224)}
    both = tmm.JointEncoderModule(source_encoder=dict(TINY), target_encoder=dict(TINY),
                                  example_input_array_shape=[2, 1, 10, 64, 64], device="cpu").example_input()
    assert both["source"].shape == both["target"].shape == (2, 1, 10, 64, 64)


def test_class_path_instantiates_in_both_packages_alike():
    node = {"class_path": "dynaclr.multi_modal.JointEncoderModule",
            "init_args": {"source_encoder": dict(TINY, stem_kernel_size=[5, 4, 4], stem_stride=[5, 4, 4]),
                          "target_encoder": dict(TINY, backbone="convnextv2_test"), "temperature": 0.1,
                          "schedule": "WarmupCosine", "device": "cpu"}}
    tmod = instantiate(node)
    assert isinstance(tmod, tmm.JointEncoderModule) and tmod.temperature == 0.1 and tmod.schedule == "WarmupCosine"
    assert tmod.model.source_encoder.stem.stem_stride == (5, 4, 4)
    assert sum(1 for n in tmod.model.state_dict() if n.endswith("grn.weight")) == 5  # the v2 target's five blocks
    jnode = {"class_path": "viscy_tpu.apps.dynaclr.multi_modal.JointEncoderModule",
             "init_args": {k: v for k, v in node["init_args"].items() if k != "device"}}
    from viscy_tpu.training.instantiate import instantiate as jinstantiate

    jmod = jinstantiate(jnode)
    assert isinstance(jmod, jmm.JointEncoderModule) and jmod.temperature == 0.1


def _write(path: Path, cfg: dict) -> str:
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_fit_resume_and_predict_through_the_cli(tmp_path):
    """``viscy-torch fit`` of a ``JointEncoderModule`` config on a tiny plate
    (Phase3D to RFP through ``HCSDataModule``, two steps and a validation
    batch), a resume from ``last`` for a second epoch, then ``predict``: the
    JAX datamodule's predict batches carry the target too, so the port
    predicts with both encoders."""
    from viscy_tpu.data.hcs import HCSDataModule as JHCS

    plate = build_hcs_plate(tmp_path / "plate.zarr", ["Phase3D", "RFP"], zyx_shape=(10, 64, 64), num_timepoints=1,
                            rows=("A",), cols=("1",), fovs=("0", "1", "2", "3", "4"), seed=21, norm_meta=True)
    norm = {"class_path": "viscy_transforms.NormalizeSampled",
            "init_args": {"keys": ["Phase3D", "RFP"], "level": "fov_statistics"}}
    crop = {"class_path": "viscy_transforms.BatchedRandSpatialCropd",
            "init_args": {"keys": ["source", "target"], "roi_size": [-1, 48, 48]}}
    data = {"data_path": str(plate), "source_channel": "Phase3D", "target_channel": "RFP", "z_window_size": 10,
            "split_ratio": 0.8, "batch_size": 2, "num_workers": 0, "yx_patch_size": [48, 48],
            "normalizations": [norm], "augmentations": [crop],
            "val_augmentations": [dict(crop, class_path="viscy_transforms.BatchedCenterSpatialCropd")]}
    model = {"class_path": "dynaclr.multi_modal.JointEncoderModule",
             "init_args": {"source_encoder": dict(TINY, stem_kernel_size=[5, 4, 4], stem_stride=[5, 4, 4]),
                           "target_encoder": dict(TINY, backbone="convnextv2_test", stem_kernel_size=[5, 4, 4],
                                                  stem_stride=[5, 4, 4]), "temperature": 0.5}}
    root = tmp_path / "run"
    fit_cfg = {"model": model, "data": {"class_path": "viscy_data.HCSDataModule", "init_args": data},
               "trainer": {"device": "cpu", "max_epochs": 1, "default_root_dir": str(root), "log_every_n_steps": 1}}
    trainer = cli.main(["fit", "-c", _write(tmp_path / "fit.yml", fit_cfg)])
    assert trainer.global_step == 2 and (root / "checkpoints" / "last").is_symlink()
    lines = [json.loads(s) for s in (root / "metrics.csv").read_text().splitlines()]
    assert [x["loss/train"] for x in lines if "loss/train" in x] and any("loss/validate" in x for x in lines)
    assert all(np.isfinite(list(x.values())).all() for x in lines)
    resumed = cli.main(["fit", "-c", _write(tmp_path / "resume.yml", dict(
        fit_cfg, trainer=dict(fit_cfg["trainer"], max_epochs=2))), "--ckpt_path", str(root / "checkpoints" / "last")])
    assert resumed.global_step == 4 and resumed.current_epoch == 1

    pred_data = {k: v for k, v in data.items() if k not in ("augmentations", "val_augmentations", "split_ratio")}
    jdm = JHCS(**{k: v for k, v in pred_data.items() if k != "normalizations"})
    jdm.setup("predict")
    jbatch = next(iter(jdm.predict_dataloader()))
    assert {"source", "target"} <= set(jbatch)  # the JAX trainer hands predict_step a target
    module = instantiate(dict(model, init_args=dict(model["init_args"], device="cpu")))
    from viscy_tpu_torch.data.hcs import HCSDataModule
    from viscy_tpu_torch.transforms import NormalizeSampled

    dm = HCSDataModule(plate, "Phase3D", "RFP", 10, batch_size=2, num_workers=0,
                       normalizations=[NormalizeSampled(keys=["Phase3D", "RFP"], level="fov_statistics")])
    preds = Trainer(device="cpu", default_root_dir=tmp_path / "pred").predict(
        module, dm, ckpt_path=root / "checkpoints" / "last", return_predictions=True)
    assert sum(len(p["features"]) for p in preds) == 5
    for p in preds:
        assert p["features"].shape[1] == p["target_features"].shape[1] == 128
        assert p["projections"].shape[1] == p["target_projections"].shape[1] == 16
        assert all(torch.isfinite(v).all() for v in p.values())
    predictor = cli.main(["predict", "-c", _write(tmp_path / "predict.yml", {
        "model": model, "data": {"class_path": "viscy_data.HCSDataModule", "init_args": pred_data},
        "trainer": {"device": "cpu", "default_root_dir": str(tmp_path / "pred_cli")},
        "ckpt_path": str(root / "checkpoints" / "last")})])
    assert isinstance(predictor, Trainer)


def test_drop_path_draws_differ_between_the_encoders():
    """With stochastic depth both encoders draw from the step's generator,
    the source first: the same generator state gives the same loss."""
    cfg = dict(TINY, drop_path_rate=0.5)
    tmod = tmm.JointEncoderModule(source_encoder=cfg, target_encoder=cfg, device="cpu").train()
    tb = {k: torch.from_numpy(_x(30 + i)) for i, k in enumerate(("source", "target"))}
    a = tmod.training_loss(tb, torch.Generator().manual_seed(1))
    b = tmod.training_loss(tb, torch.Generator().manual_seed(1))
    c = tmod.training_loss(tb, torch.Generator().manual_seed(2))
    assert float(a.detach()) == float(b.detach()) != float(c.detach())
