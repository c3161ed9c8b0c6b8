"""Rotation-TTA prediction (``AugmentedPredictionVSUNet``), the host
segmentation metrics (``voi_score``, ``pod_metric``) and the segmentation
test stage (``SegmentationMetrics2D`` over ``SegmentationDataModule``
through ``Trainer.test``) in the port against viscy_tpu.

A narrow FCMAE-UNeXt2 with numpy-seeded weights reaches the port through
its flax bridge; the JAX predictor runs as it is, around the model's
``apply`` under ``jax.jit`` (one trace a shape, shared by every rotation
and reduction). Tolerances
(float32): predictions within 2e-3 of the range with Pearson r > 0.9999;
host metrics equal to 1e-12; label plates written by the port's writer
(uncompressed), which the JAX reader reads too.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.apps.cytoland import evaluation as jeval
from viscy_tpu.apps.cytoland import prediction as jpred
from viscy_tpu.data import segmentation as jseg
from viscy_tpu.evaluation import metrics as jmetrics
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training.trainer import Trainer as JTrainer
from viscy_tpu_torch.apps.cytoland import evaluation as teval
from viscy_tpu_torch.apps.cytoland import prediction as tpred
from viscy_tpu_torch.apps.cytoland.engine import VSUNet
from viscy_tpu_torch.data import segmentation as tseg
from viscy_tpu_torch.evaluation import metrics as tmetrics
from viscy_tpu_torch.training.convert import load_flax_params
from viscy_tpu_torch.training.instantiate import resolve_class
from viscy_tpu_torch.training.trainer import Trainer
from viscy_tpu_torch.zarr_io.store import open_ome_zarr

from _torch_port_helpers import assert_rel_close, flax_params

# narrow stand-in for configs/vscyto3d_predict.yml's FCMAE (dims 96-768, depth 15)
TINY = dict(in_channels=1, out_channels=2, encoder_blocks=(1, 1, 1, 1), dims=(8, 16, 32, 64),
            stem_kernel_size=(5, 4, 4), in_stack_depth=5, decoder_conv_blocks=1, pretraining=False)


def _x(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models():
    """The JAX model and its seeded params, and the port model on them."""
    jmod = JFCMAE(**TINY)
    params = flax_params(jmod, 7, jnp.zeros((1, 1, 5, 32, 32)))
    tmod = VSUNet("fcmae", dict(TINY), device="cpu").model.eval()
    load_flax_params(tmod, params)
    return jmod, {"params": params}, tmod


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The JAX model as the predictor reads it: ``apply`` jitted, its
    ``num_blocks``, ``downsamples_z`` and ``out_stack_depth``."""
    jmod, _, _ = _models()
    return SimpleNamespace(apply=jax.jit(jmod.apply), num_blocks=jmod.num_blocks,
                           downsamples_z=getattr(jmod, "downsamples_z", False), out_stack_depth=jmod.out_stack_depth)


def _jax_tta(reduction: str):
    return jpred.AugmentedPredictionVSUNet.with_rotation_tta(_jax_model(), 4, reduction)


# -- the median trap ------------------------------------------------------------------------------------


def test_the_median_of_four_averages_the_two_middle_values():
    """``jnp.median`` over an even count averages the two middle values;
    ``torch.median`` returns the lower one. The port's reduction is the
    former, and the latter misses it on the same stack."""
    stacked = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (4, 3, 5, 6)).astype(np.float32))
    want = np.asarray(jnp.median(jnp.asarray(stacked.numpy()), axis=0))
    np.testing.assert_allclose(tpred.tta_median(stacked).numpy(), want, rtol=0, atol=1e-7)
    assert not np.allclose(torch.median(stacked, dim=0).values.numpy(), want, rtol=0, atol=1e-3)
    odd = stacked[:3]
    np.testing.assert_array_equal(tpred.tta_median(odd).numpy(), np.asarray(jnp.median(jnp.asarray(odd.numpy()), 0)))


# -- AugmentedPredictionVSUNet ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduction,yx", [("mean", (32, 48)), ("median", (40, 36))],
                         ids=["mean-divisible", "median-padded"])
def test_rotation_tta_matches_jax(reduction, yx):
    """Four rotations, non-square FOVs: one the model's 2^4 factor divides,
    one it does not (divisible pad, forward, center crop, inverse
    rotation)."""
    _, variables, tmod = _models()
    x = _x((1, 1, 5, *yx), sum(yx))
    want = np.asarray(_jax_tta(reduction).predict_step(variables, {"source": jnp.asarray(x)}))
    port = tpred.AugmentedPredictionVSUNet.with_rotation_tta(tmod, 4, reduction)
    with torch.no_grad():
        got = port.predict_step({"source": torch.from_numpy(x)})
    assert got.shape == want.shape == (1, 2, 5, *yx)
    assert_rel_close(got.numpy(), want, 2e-3, 0.9999)


def test_one_identity_transform_is_the_plain_pad_forward_crop():
    """No transforms: the prediction equals ``VSUNet``'s own predict step."""
    _, _, tmod = _models()
    x = torch.from_numpy(_x((1, 1, 5, 40, 36), 3))
    engine = VSUNet("fcmae", dict(TINY), device="cpu")
    engine.model.load_state_dict(tmod.state_dict())
    with torch.no_grad():
        got = tpred.AugmentedPredictionVSUNet(tmod).predict_step({"source": x})
        want = engine.eval().predict_step({"source": x})
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sliding_windows_match_jax():
    """Z windows of the model's depth every 2 slices through the median TTA
    (starts 0, 2, 4 over depth 9), blended by ``blend_in``."""
    step = 2
    jmod, variables, tmod = _models()
    x = _x((1, 1, 9, 32, 32), 11 + step)
    want = _jax_tta("median").predict_sliding_windows(variables, jnp.asarray(x), out_channel=2, step=step)
    port = tpred.AugmentedPredictionVSUNet.with_rotation_tta(tmod, 4, "median")
    got = port.predict_sliding_windows(x, out_channel=2, step=step)
    assert got.shape == want.shape == (1, 2, 9, 32, 32)
    assert_rel_close(got, want, 2e-3, 0.9999)
    with pytest.raises(ValueError, match="in_stack_depth 5 > input depth 4"):
        port.predict_sliding_windows(x[:, :, :4])


class _Sources:
    """A predict datamodule of the given source batches."""

    def __init__(self, batches):
        self.batches = batches

    def setup(self, stage):
        pass

    def predict_dataloader(self):
        return [{"source": b} for b in self.batches]


def test_trainer_predict_runs_the_tta_module():
    """``Trainer.predict`` with the TTA module: each batch's prediction is
    the module's own call on it; the module refuses an unknown reduction."""
    _, _, tmod = _models()
    module = tpred.AugmentedPredictionVSUNet.with_rotation_tta(tmod, 4, "median")
    batches = [_x((1, 1, 5, 32, 48), s) for s in (1, 2)]
    preds = Trainer(device="cpu", use_tensorboard=False).predict(module, _Sources(batches), return_predictions=True)
    for b, p in zip(batches, preds):
        with torch.no_grad():
            torch.testing.assert_close(p, module.predict_step({"source": torch.from_numpy(b)}), rtol=0, atol=0)
    with pytest.raises(ValueError, match="reduction"):
        tpred.AugmentedPredictionVSUNet(tmod, reduction="max")


# -- host metrics ---------------------------------------------------------------------------------------------


def _labels(seed: int, shape=(48, 40), n: int = 6) -> np.ndarray:
    """Rectangular instances (some overlapping, so some labels are cut)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(shape, np.int16)
    for i in range(1, n + 1):
        y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        h, w = rng.integers(4, 12, 2)
        out[y:y + h, x:x + w] = i
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_voi_and_pod_equal_jax(seed):
    pred, target = _labels(seed), _labels(seed + 10)
    if seed == 3:
        target = pred.copy()  # every instance matched, VOI 0
    assert tmetrics.voi_score(pred, target) == jmetrics.voi_score(pred, target)
    for thr in (0.5, 0.1):
        assert tmetrics.pod_metric(pred, target, thr) == jmetrics.pod_metric(pred, target, thr)


# -- the segmentation test stage -----------------------------------------------------------------------------


def _label_plates(root, seed: int = 5):
    """Prediction and target plates of three FOVs (two wells) with two z
    slices; the target holds one FOV the prediction lacks."""
    paths = {}
    rng = np.random.default_rng(seed)
    for side, fovs in (("pred", ("A/1/0", "A/1/1", "B/2/0")), ("target", ("A/1/0", "A/1/1", "B/2/0", "B/2/1"))):
        path = root / f"{side}.zarr"
        plate = open_ome_zarr(path, layout="hcs", mode="w-", channel_names=["seg", "other"])
        for i, name in enumerate(fovs):
            row, col, fov = name.split("/")
            labels = np.stack([_labels(seed * 100 + 10 * i + z + (side == "target") * int(rng.integers(0, 2)))
                               for z in range(2)])
            data = np.stack([labels, np.zeros_like(labels)]).astype(np.float32)[None]
            plate.create_position(row, col, fov).create_image("0", data)
        paths[side] = path
    return paths


def test_segmentation_metrics_through_trainer_test_equal_jax(tmp_path):
    """``Trainer.test(SegmentationMetrics2D(), SegmentationDataModule(...))``:
    every metric's mean over the six slices equals the JAX trainer's to
    1e-12, and each batch's metrics equal the plain computation."""
    paths = _label_plates(tmp_path)
    args = (paths["pred"], paths["target"], "seg", "seg")
    want = JTrainer(default_root_dir=tmp_path / "jax").test(jeval.SegmentationMetrics2D(),
                                                           jseg.SegmentationDataModule(*args, num_workers=0))
    seen = []

    class Spy(teval.SegmentationMetrics2D):
        def test_step(self, batch):
            out = super().test_step(batch)
            seen.append((batch["pred"].numpy()[0], batch["target"].numpy()[0], out))
            return out

    got = Trainer(device="cpu", default_root_dir=tmp_path / "torch", use_tensorboard=False).test(
        Spy(), tseg.SegmentationDataModule(*args, num_workers=0))
    assert set(got) == set(want) and len(seen) == 6
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    for pred, target, out in seen:
        assert out["test_metrics/pod_f1"] == jmetrics.pod_metric(pred, target)["f1"]
        assert out["test_metrics/voi"] == sum(jmetrics.voi_score(pred, target))
        tp = np.logical_and(pred > 0, target > 0).sum()
        assert out["test_metrics/dice"] == 2 * tp / max((pred > 0).sum() + (target > 0).sum(), 1)
    lines = (tmp_path / "torch" / "metrics.csv").read_text().splitlines()
    assert len(lines) == 1 and "test/test_metrics/dice" in lines[0]


def test_segmentation_datamodule_refusals_and_class_paths(tmp_path):
    paths = _label_plates(tmp_path)
    with pytest.raises(ValueError, match="batch_size=1"):
        tseg.SegmentationDataModule(paths["pred"], paths["target"], "seg", "seg", batch_size=2)
    dm = tseg.SegmentationDataModule(paths["pred"], paths["target"], "seg", "seg")
    with pytest.raises(NotImplementedError, match="only supports testing"):
        dm.setup("fit")
    dm.setup("test")
    ds = jseg.SegmentationDataModule(paths["pred"], paths["target"], "seg", "seg")
    ds.setup("test")
    assert len(dm.test_dataset) == len(ds.test_dataset) == 6
    for i in (0, 3, 5):
        a, b = dm.test_dataset[i], ds.test_dataset[i]
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert resolve_class("viscy_data.segmentation.SegmentationDataModule") is tseg.SegmentationDataModule
    assert resolve_class("cytoland.evaluation.SegmentationMetrics2D") is teval.SegmentationMetrics2D
    assert resolve_class("cytoland.prediction.AugmentedPredictionVSUNet") is tpred.AugmentedPredictionVSUNet
