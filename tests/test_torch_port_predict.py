"""viscy_tpu_torch predict path (engine, tiling, trainer) against viscy_tpu.

Shape plumbing (divisible pad, center crop, tile origins, hat weights,
tiled blending with a stub forward, rotations) must agree exactly or to
1e-6; the model-backed predict steps to the torch-parity bound, max|d| <=
2e-3 of the output range and Pearson r > 0.9999 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.apps.cytoland import prediction as jpred
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.apps.cytoland import prediction as tpred
from viscy_tpu_torch.training.callbacks.base import Callback
from viscy_tpu_torch.training.convert import load_flax_params
from viscy_tpu_torch.training.trainer import Trainer

from _torch_port_helpers import NARROW, assert_rel_close, flax_params


def _rand(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("pad_z", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 5, 33, 47), (2, 1, 7, 64, 31)])
def test_divisible_pad_and_center_crop_match_jax(shape, pad_z):
    x = _rand(shape)
    got = tengine._divisible_pad(torch.from_numpy(x), 16, pad_z=pad_z)
    want = np.asarray(jengine._divisible_pad(jnp.asarray(x), 16, pad_z=pad_z))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tengine._center_crop_to_shape(got, shape[2:]).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(jengine._center_crop_to_shape(jnp.asarray(want), shape[2:]))
    )


@pytest.mark.parametrize("size,tile", [(2048, 320), (100, 64), (64, 64), (50, 64), (300, 97)])
def test_tile_positions_and_hat_weights_match_jax(size, tile):
    np.testing.assert_array_equal(tpred.tile_positions(size, tile), jpred.tile_positions(size, tile))
    ty = min(tile, size)
    np.testing.assert_array_equal(tpred._hat_weights_2d(ty, tile), jpred._hat_weights_2d(ty, tile))


def test_tiled_forward_yx_with_stub_forward_matches_jax():
    x = _rand((2, 1, 3, 70, 53), seed=1)

    def jfwd(t):
        return jnp.concatenate([t * 2.0, t * t], axis=1)

    def tfwd(t):
        return torch.cat([t * 2.0, t * t], dim=1)

    calls = []
    got = tpred.tiled_forward_yx(
        lambda t: calls.append(t.shape[0]) or tfwd(t), torch.from_numpy(x), tile=(32, 24), tile_batch=5
    )
    want = np.asarray(jpred.tiled_forward_yx(jfwd, jnp.asarray(x), tile=(32, 24), tile_batch=5))
    assert got.shape == (2, 2, 3, 70, 53)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # every tile of both samples went through the stub in batches of <= 5
    assert sum(calls) == 2 * len(tpred.tile_positions(70, 32)) * len(tpred.tile_positions(53, 24))
    assert max(calls) <= 5


def test_rotation_tta_transforms_match_jax():
    x = _rand((1, 2, 3, 5, 4), seed=2)
    tf, ti = tpred.rotation_tta_transforms(4)
    jf, ji = jpred.rotation_tta_transforms(4)
    for a, b, c, d in zip(tf, ti, jf, ji):
        np.testing.assert_array_equal(a(torch.from_numpy(x)).numpy(), np.asarray(c(jnp.asarray(x))))
        np.testing.assert_array_equal(b(a(torch.from_numpy(x))).numpy(), x)
    with pytest.raises(ValueError):
        tpred.rotation_tta_transforms(0)


@pytest.fixture(scope="module")
def narrow_params():
    x = jnp.zeros((1, 1, 15, 32, 32), jnp.float32)
    from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE

    return flax_params(JFCMAE(**NARROW), 11, x)


def _engines(params, **kwargs):
    jmod = jengine.VSUNet(architecture="fcmae", model_config=dict(NARROW), **kwargs)
    tmod = tengine.VSUNet(architecture="fcmae", model_config=dict(NARROW), device="cpu", **kwargs)
    load_flax_params(tmod.model, params)
    return jmod, tmod


def test_vsunet_tiled_predict_step_matches_jax(narrow_params):
    """Non-divisible 100x90 FOV, 64x64 tiles in batches of 3 (the JAX
    model runs unfused: it equals the fused path, see test_fused_block)."""
    jmod, tmod = _engines(narrow_params, tile_yx=(64, 64), tile_batch=3)
    src = _rand((1, 1, 15, 100, 90), seed=3)
    want = np.asarray(jax.jit(jmod.predict_step)({"params": narrow_params}, {"source": jnp.asarray(src)}))
    with torch.inference_mode():
        got = tmod.predict_step({"source": torch.from_numpy(src)}).numpy()
    assert got.shape == want.shape == (1, 2, 15, 100, 90)
    assert_rel_close(got, want, 2e-3, 0.9999)


@pytest.mark.parametrize("tta_type", ["mean", "median"])
def test_vsunet_rotation_tta_predict_step_matches_jax(narrow_params, tta_type):
    jmod, tmod = _engines(
        narrow_params, tile_yx=(32, 32), tile_batch=4, test_time_augmentations=True, tta_type=tta_type
    )
    src = _rand((1, 1, 15, 48, 40), seed=4)
    want = np.asarray(jax.jit(jmod.predict_step)({"params": narrow_params}, {"source": jnp.asarray(src)}))
    with torch.inference_mode():
        got = tmod.predict_step({"source": torch.from_numpy(src)}).numpy()
    assert_rel_close(got, want, 2e-3, 0.9999)


class _Recorder(Callback):
    def __init__(self):
        self.events = []

    def on_predict_start(self, trainer, module):
        self.events.append("start")

    def write_on_batch_end(self, trainer, module, prediction, batch, batch_idx):
        self.events.append(
            ("batch", batch_idx, tuple(prediction.shape), torch.is_inference_mode_enabled())
        )

    def on_predict_end(self, trainer, module):
        self.events.append("end")


class _DataModule:
    def __init__(self, fovs):
        self.fovs = fovs
        self.stages = []

    def setup(self, stage):
        self.stages.append(stage)

    def predict_dataloader(self):
        for fov in self.fovs:
            yield {"source": fov, "index": 0}


def test_trainer_predict_drives_callbacks_and_returns_predictions(narrow_params):
    _, tmod = _engines(narrow_params)
    fovs = [_rand((1, 1, 15, 32, 32), seed=s) for s in (5, 6)]
    rec = _Recorder()
    dm = _DataModule(fovs)
    preds = Trainer(callbacks=[rec], device="cpu").predict(tmod, dm, return_predictions=True)
    assert dm.stages == ["predict"]
    shape = (1, 2, 15, 32, 32)
    assert rec.events == ["start", ("batch", 0, shape, True), ("batch", 1, shape, True), "end"]
    with torch.inference_mode():
        for fov, pred in zip(fovs, preds):
            torch.testing.assert_close(pred, tmod.predict_step({"source": torch.from_numpy(fov)}))
    assert Trainer(device="cpu").predict(tmod, _DataModule(fovs[:1])) is None
