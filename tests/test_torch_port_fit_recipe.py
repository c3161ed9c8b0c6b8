"""The fit recipe's losses, transforms and stochastic depth in the port
against viscy_tpu: SpotlightLoss and the fg_mask route, the recipe's
augmentations through ``Trainer(device="cpu")`` with a resume, AdamW after
clipping against optax, and drop path in the trainer.

The tiny FCMAE of tests/_torch_port_fit_common.py with seeded JAX weights
in both packages, TF32 off. Tolerances, float32: losses to 1e-5 relative
(SpotlightLoss alone to 1e-6); every gradient to 2e-3 of its range with
Pearson r > 0.9999 (the torch-parity bound); parameters to 1e-6 against
optax; drop-path runs with one seed bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.training.losses.spotlight import SpotlightLoss as JSpotlightLoss
from viscy_tpu.training.losses.spotlight import otsu_threshold_batch as j_otsu
from viscy_tpu_torch import transforms as T
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.data.gpu_aug import DeviceTransformDataModule
from viscy_tpu_torch.training.callbacks.checkpoint import LearningRateMonitor, ModelCheckpoint
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss
from viscy_tpu_torch.training.losses.spotlight import SpotlightLoss, otsu_threshold_batch
from viscy_tpu_torch.training.optimizers import clip_by_global_norm_, configure_adamw_scheduler
from viscy_tpu_torch.training.trainer import Trainer

from _torch_port_fit_common import (  # noqa: F401  (fixtures)
    ENGINE,
    TINY,
    UNBRIDGED,
    _batch,
    _jax_engine,
    _no_tf32,
    _torch_engine,
    params,
)
from _torch_port_helpers import assert_rel_close


# -- SpotlightLoss and the fg_mask route --------------------------------------------


def _pred_target(seed, shape=(2, 2, 5, 16, 16)):
    rng = np.random.default_rng(seed)
    return rng.normal(0.3, 0.5, shape).astype(np.float32), rng.random(shape).astype(np.float32)


def _bimodal(shape, seed):
    """A fluorescence-like target: 70 % background near 0.15, 30 %
    foreground near 0.7, each (sample, channel) spanning exactly [0, 1].

    Otsu's last bin (an empty upper class) divides the rounding error of
    ``cumsum[-1] - sum`` by 1e-10 in both packages (viscy_tpu
    ``losses/spotlight.py:_otsu_1d``), so where those sums round, the pick
    follows the summation order, which XLA and torch do not share. With a
    [0, 1] span the bin centers are dyadic and every sum is exact, so the
    two packages compare what the formula computes. (That formula puts
    this target's threshold near 0.045, where ``preprocess/stats.py``'s
    skimage rule puts it near 0.40: ROADMAP Queue 3.)"""
    rng = np.random.default_rng(seed)
    fg = rng.random(shape) < 0.3
    x = np.where(fg, rng.normal(0.7, 0.1, shape), rng.normal(0.15, 0.05, shape))
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    flat = x.reshape(shape[0] * shape[1], -1)
    flat[:, 0], flat[:, 1] = 0.0, 1.0
    return flat.reshape(shape)


@pytest.mark.parametrize("case", ["fg_mask", "threshold", "otsu", "otsu-tied", "empty-mask"])
def test_spotlight_loss_matches_jax(case):
    pred, target = _pred_target(1)
    kw, mask = {}, None
    if case == "fg_mask":
        mask = target > 0.6
    elif case == "empty-mask":
        mask = np.zeros_like(target, bool)
        mask[0, 0] = True  # one all-foreground channel, the rest empty
    elif case == "threshold":
        kw = dict(fg_threshold=0.4)
    elif case == "otsu":
        target = _bimodal(target.shape, 1)
    elif case == "otsu-tied":
        target = (target > 0.5).astype(np.float32)  # two values: every split ties
    want = JSpotlightLoss(lambda_mse=0.3, **kw)(jnp.asarray(pred), jnp.asarray(target),
                                                 None if mask is None else jnp.asarray(mask))
    got = SpotlightLoss(lambda_mse=0.3, **kw)(torch.from_numpy(pred), torch.from_numpy(target),
                                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_otsu_thresholds_match_jax_with_tied_maxima():
    target = _bimodal((2, 2, 5, 16, 16), 2)
    target[0, 0] = (target[0, 0] > 0.5)  # tied maxima: the first wins on both sides
    target[1, 1] = 0.25  # constant channel
    want = np.asarray(j_otsu(jnp.asarray(target)))
    got = otsu_threshold_batch(torch.from_numpy(target)).numpy()
    assert got.shape == want.shape == (2, 2, 1, 1, 1)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].item() < 0.01  # the first tied bin, not the last


def test_training_loss_routes_fg_mask_to_spotlight(params):
    """``VSUNet.training_loss`` on an fg_mask batch: the loss and every
    parameter gradient against ``jax.grad`` of the JAX engine's."""
    batch = _batch(3, mask=True)
    jmod = _jax_engine(params, loss=JSpotlightLoss())

    @jax.jit
    def value_and_grad(p, b):
        return jax.value_and_grad(lambda p: jmod.training_loss({"params": p}, b, jax.random.PRNGKey(0))[0])(p)

    jloss, jgrads = value_and_grad(jax.tree_util.tree_map(jnp.asarray, params),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    tmod = _torch_engine(params, loss=SpotlightLoss())
    loss = tmod.training_loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in tmod.model.named_parameters():
        if name not in UNBRIDGED:
            assert_rel_close(p.grad.numpy(), want[name].numpy(), 2e-3, 0.9999)


def _drop_path_engine(params, rate=0.1, **kw):
    tmod = tengine.VSUNet("fcmae", dict(TINY, fused_mlp=True, encoder_drop_path_rate=rate),
                          loss_function=MixedLoss(0.5, 0.0, 0.5), device="cpu", **ENGINE, **kw)
    load_flax_params(tmod.model, params)
    return tmod


def test_training_refuses_encoder_drop_path(params):
    """A model with stochastic depth refuses to train without a generator
    for its draws (no global RNG), while its eval-mode loss (no drop path
    on either side) equals that of the same weights at rate 0, to 1e-6
    relative."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    tmod = _drop_path_engine(params)
    with pytest.raises(ValueError, match="Generator"):
        tmod.training_loss(batch)
    tmod.eval()
    with torch.no_grad():
        got = float(tmod.validation_loss(batch))
        want = float(_torch_engine(params).eval().validation_loss(batch))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_fit_with_drop_path_draws_from_the_trainer_generator(params, tmp_path):
    """``Trainer.fit`` trains a model with stochastic depth: two runs with
    one seed end bit for bit equal without touching global RNG state, and
    another seed (other keep masks) ends elsewhere. (Rate 0.5, so both
    seeds drop branches in two steps of two samples.)"""

    class Two(DeviceTransformDataModule):
        def train_dataloader(self):
            return [_batch(160 + i) for i in range(2)]

    def run(seed):
        tmod = _drop_path_engine(params, 0.5)
        Trainer(max_epochs=1, default_root_dir=tmp_path / str(seed), seed=seed, device="cpu").fit(tmod, Two())
        return tmod.model.state_dict()

    before = torch.random.get_rng_state()
    a, b = run(1), run(1)
    assert torch.equal(torch.random.get_rng_state(), before)
    other = run(2)
    for n, v in a.items():
        assert torch.equal(v, b[n]), n
    name = "encoder.stages.0.blocks.0.mlp.fc1.weight"
    assert not torch.equal(a[name], other[name])


# -- the recipe end to end on the CPU, and the rest of the trainer's surface ----------


def _recipe_aug(keys):
    return T.Compose([
        T.NormalizeSampled(keys=["source", "target"], level="fov_statistics"),
        T.BatchedRandFlipd(keys=keys, prob=0.5),
        T.BatchedRandAffined(keys=keys, prob=0.5, rotate_range=[3.14, 0.0, 0.0],
                             scale_range=[[1.0, 1.3], [0.75, 1.3], [0.75, 1.3]]),
        T.BatchedRandAdjustContrastd(keys=["source"], gamma=[0.8, 1.2], prob=0.3),
        T.BatchedRandGaussianNoised(keys=["source"], prob=0.5, std=0.5),
    ])


def _with_meta(batch, seed):
    rng = np.random.default_rng(seed)
    n = batch["source"].shape[0]
    meta = {k: {"fov_statistics": {"mean": rng.random(n).astype(np.float32),
                                   "std": 0.5 + rng.random(n).astype(np.float32)}}
            for k in ("source", "target")}
    return dict(batch, norm_meta=meta)


@pytest.mark.parametrize("loss", ["mixed", "spotlight-fg_mask"])
def test_recipe_fit_and_resume_run_on_the_cpu(params, tmp_path, loss):
    """The VSCyto3D fit recipe through ``Trainer(device="cpu")``:
    NormalizeSampled and the config's flip, affine, contrast and noise,
    validation, ModelCheckpoint, LearningRateMonitor, the CSV log,
    clipping, accumulation and freeze_encoder; then a resume from ``last``."""
    spot = loss != "mixed"
    keys = ["source", "target", "fg_mask"] if spot else ["source", "target"]

    class Recipe(DeviceTransformDataModule):
        train_device_transforms = _recipe_aug(keys)

        def train_dataloader(self):
            return [_with_meta(_batch(100 + i, mask=spot), i) for i in range(2)]

        def val_dataloader(self):
            return [_with_meta(_batch(110, mask=spot), 9)]

    def engine():
        return _torch_engine(params, loss=SpotlightLoss() if spot else None, freeze_encoder=True)

    tmod = engine()
    frozen = tmod.model.encoder.stem.conv3d.weight.detach().clone()
    kw = dict(default_root_dir=tmp_path, seed=3, log_every_n_steps=1, gradient_clip_val=0.5,
              accumulate_grad_batches=2, device="cpu")
    trainer = Trainer(max_epochs=2, callbacks=[ModelCheckpoint(save_top_k=5), LearningRateMonitor()], **kw)
    trainer.fit(tmod, Recipe())
    assert trainer.global_step == 4 and trainer.scheduler.last_epoch == 2
    assert torch.equal(tmod.model.encoder.stem.conv3d.weight, frozen)
    lines = [json.loads(s) for s in (tmp_path / "metrics.csv").read_text().splitlines()]
    assert any("loss/validate" in line for line in lines) and any("lr" in line for line in lines)
    assert all(np.isfinite(v) for line in lines for v in line.values())
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert len(names) == 3 and names[-1] == "last" and names[0].startswith("epoch=0-step=2-loss=")
    resumed = Trainer(max_epochs=3, **kw)
    fresh = engine()
    resumed.fit(fresh, Recipe(), ckpt_path=tmp_path / "checkpoints" / "last")
    assert resumed.global_step == 6 and resumed.current_epoch == 2
    assert torch.equal(fresh.model.encoder.stem.conv3d.weight, frozen)


def test_clip_by_global_norm_then_adamw_matches_optax():
    """``clip_by_global_norm_`` before the AdamW step is
    ``optax.chain(optax.clip_by_global_norm(c), optax.adamw(...))`` on a
    gradient above the bound and one below it, to 1e-6."""
    import optax

    rng = np.random.default_rng(5)
    w = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    gs = [[rng.normal(size=x.shape).astype(np.float32) * s for x in w] for s in (3.0, 0.01)]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(1e-2, weight_decay=1e-2))
    jp = [jnp.asarray(x) for x in w]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in w]
    opt, sched, _ = configure_adamw_scheduler(tp, lr=1e-2)
    for g in gs:  # the first clipped, the second not
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        clip_by_global_norm_(tp, 0.5)
        opt.step()
        sched.step()
    for p, x in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(x), atol=1e-6, rtol=0)

