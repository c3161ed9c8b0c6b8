"""Shared set-up of the pipeline fits of tests/test_torch_port_transforms_*:
one tiny seeded plate, a config naming its augmentations by class path,
``viscy-torch fit`` (``cli.main``) on it against viscy_tpu's ``Trainer``
on the same plate through the JAX datamodule, for two steps.

Both models start from the same seeded JAX weights (the port's engine loads
them as the CLI builds it); the port's device augmentation takes the draws
the JAX trainer's step keys give (PRNGKey(seed + 1), one split per step,
the second half of a split of the step key for the augmentation)."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import yaml

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training.instantiate import instantiate as j_instantiate
from viscy_tpu.training.trainer import Trainer as JTrainer
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.data.hcs import HCSDataModule
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_draws import compose_draws, to_torch
from _torch_port_helpers import assert_rel_close, flax_params

CHANNELS = ["Phase3D", "Nucleus", "Membrane"]
# the smallest FCMAE-UNeXt2 of the fit tests: one block a stage, one
# decoder block, dims 8-64, depth 5, 1 -> 2 channels
MINI = dict(in_channels=1, out_channels=2, encoder_blocks=(1, 1, 1, 1), dims=(8, 16, 32, 64),
            stem_kernel_size=(5, 4, 4), in_stack_depth=5, decoder_conv_blocks=1, pretraining=False)
ENGINE = dict(lr=1e-3, schedule="WarmupCosine", warmup_steps=1)
PATCH = 32
SEED = 3
STEPS = 2


def tiny_plate(path: Path, with_mask: bool = False) -> Path:
    """Four seeded FOVs of (1, 3, 8, 48, 48); with ``with_mask`` a seeded
    binary ``fg_mask`` array of the same layout."""
    plate = build_hcs_plate(path, CHANNELS, zyx_shape=(8, 48, 48), num_timepoints=1, rows=("A",), cols=("1",),
                            fovs=("0", "1", "2", "3"), seed=SEED)
    if with_mask:
        rng = np.random.default_rng(SEED)
        for _, pos in open_ome_zarr(plate, mode="r+").positions():
            shape = pos["0"].shape
            mask = pos.create_zeros("fg_mask", shape=shape, dtype=np.uint8, chunks=(1, 1, *shape[2:]))
            mask[:] = (rng.random(shape) > 0.5).astype(np.uint8)
    return plate


MIXED = {"class_path": "viscy_utils.losses.MixedLoss",
         "init_args": {"l1_alpha": 0.5, "l2_alpha": 0.0, "ms_dssim_alpha": 0.5}}


def fit_config(root: Path, plate: Path, augmentations: list, loss: dict = MIXED, **data) -> dict:
    model = {"class_path": "cytoland.engine.VSUNet",
             "init_args": {"architecture": "fcmae", "model_config": dict(MINI), **ENGINE, "loss_function": loss}}
    init = {"data_path": str(plate), "source_channel": "Phase3D", "target_channel": ["Nucleus", "Membrane"],
            "z_window_size": 5, "split_ratio": 0.75, "batch_size": 4, "num_workers": 0,
            "yx_patch_size": [PATCH, PATCH], "normalizations": [], "augmentations": augmentations, "seed": SEED}
    init.update(data)
    trainer = {"device": "cpu", "max_epochs": 1, "limit_train_batches": STEPS, "default_root_dir": str(root),
               "log_every_n_steps": 1, "seed": SEED, "check_val_every_n_epoch": 100,
               "checkpoint_every_n_epochs": 100, "use_tensorboard": False}
    return {"model": model, "data": {"class_path": "viscy_data.HCSDataModule", "init_args": init},
            "trainer": trainer}


def _jax_aug_keys(seed: int, steps: int) -> list:
    rng, keys = jax.random.PRNGKey(seed + 1), []
    for _ in range(steps):
        rng, step_rng = jax.random.split(rng)
        keys.append(jax.random.split(step_rng)[1])
    return keys


def mini_params():
    """Seeded JAX weights of ``MINI``."""
    return flax_params(JFCMAE(**MINI), 31, jnp.zeros((1, 1, 5, 32, 32)))


def fit_both(tmp_path: Path, params, cfg: dict, monkeypatch):
    """The JAX trainer's and ``viscy-torch fit``'s two steps on ``cfg``;
    returns the JAX trainer, the port trainer and engine, and the stages
    the port's device transform ran."""
    jdm = j_instantiate(cfg["data"])
    jmod = jengine.VSUNet("fcmae", dict(MINI, fused_mlp=False), **ENGINE,
                          loss_function=j_instantiate(cfg["model"]["init_args"]["loss_function"]))
    jmod.init_variables = lambda rng, batch: {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    jtrainer = JTrainer(default_root_dir=tmp_path / "jax", use_tensorboard=False, seed=SEED, max_epochs=1,
                        log_every_n_steps=1,
                        limit_train_batches=STEPS, check_val_every_n_epoch=100, checkpoint_every_n_epochs=100)
    jtrainer.fit(jmod, jdm)

    built, seen = [], []
    keys = _jax_aug_keys(SEED, STEPS)
    jax_draws = jax.jit(functools.partial(compose_draws, jdm._device_compose))
    init = tengine.VSUNet.__init__

    @functools.wraps(init)
    def init_with_jax_weights(self, *a, **kw):
        init(self, *a, **kw)
        load_flax_params(self.model, params)
        built.append(self)

    transform = HCSDataModule.device_transform

    def with_jax_draws(self, batch, generator=None, stage="train", draws=None):
        if stage == "train" and self._device_compose is not None:
            jbatch = {k: jnp.asarray(batch[k].float().numpy()) for k in ("source", "target", "fg_mask")
                      if k in batch}
            draws = to_torch(jax_draws(jbatch, keys[len(seen)])[1])
        seen.append(stage)
        return transform(self, batch, generator, stage, draws)

    monkeypatch.setattr(tengine.VSUNet, "__init__", init_with_jax_weights)
    monkeypatch.setattr(HCSDataModule, "device_transform", with_jax_draws)
    path = tmp_path / "fit.yml"
    path.write_text(yaml.safe_dump(cfg))
    trainer = cli.main(["fit", "-c", str(path)])
    return jtrainer, trainer, built[-1], seen


def assert_steps_match(jtrainer, trainer, tmod) -> None:
    """Two steps each, the same last loss to 1e-4 relative, and every
    parameter within 2e-3 of its range with r > 0.9999."""
    assert jtrainer.global_step == trainer.global_step == STEPS
    np.testing.assert_allclose(trainer.logged_metrics["loss/train"], jtrainer.logged_metrics["loss/train"],
                               rtol=1e-4)
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    for name, p in tmod.model.named_parameters():
        if name in want:
            assert_rel_close(p.detach().numpy(), want[name].numpy(), 2e-3, 0.9999)
