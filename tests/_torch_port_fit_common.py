"""Shared set-up of the fit tests (test_torch_port_fit.py and
test_torch_port_fit_recipe.py): the tiny FCMAE-UNeXt2 (blocks (1, 1, 2,
1), dims 16-128, depth 5, 1 -> 2 channels; the port fused, the JAX side
unfused) with seeded JAX weights carried across by the weight bridge,
numpy-seeded batches, and each package's engine and trainer on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training.losses.mixed_loss import MixedLoss as JMixedLoss
from viscy_tpu.training.trainer import Trainer as JTrainer
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss
from viscy_tpu_torch.training.trainer import Trainer

from _torch_port_helpers import flax_params

TINY = dict(
    in_channels=1,
    out_channels=2,
    encoder_blocks=(1, 1, 2, 1),
    dims=(16, 32, 64, 128),
    stem_kernel_size=(5, 4, 4),
    in_stack_depth=5,
    decoder_conv_blocks=2,
    pretraining=False,
)
ENGINE = dict(lr=1e-3, schedule="WarmupCosine", warmup_steps=1)
UNBRIDGED = {"encoder.stem.conv2d.weight", "encoder.stem.conv2d.bias"}
NEVER = 10**6  # checkpoint_every_n_epochs that never saves


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _batch(seed, n=2, mask=False):
    rng = np.random.default_rng(seed)
    out = {
        "source": rng.random((n, 1, 5, 64, 64), np.float32),
        "target": rng.random((n, 2, 5, 64, 64), np.float32),
    }
    if mask:
        out["fg_mask"] = rng.random((n, 2, 5, 64, 64)) > 0.7
    return out


@pytest.fixture(scope="module")
def params():
    return flax_params(JFCMAE(**TINY), 31, jnp.zeros((1, 1, 5, 64, 64)))


class _Data:
    """Datamodule of fixed numpy batches for either package's trainer."""

    def __init__(self, train, val=None):
        self.train, self.val = train, val

    def prepare_data(self):
        pass

    def setup(self, stage):
        pass

    def train_dataloader(self):
        return list(self.train)

    def val_dataloader(self):
        return None if self.val is None else list(self.val)


def _jax_engine(params, loss=None, **kw):
    jmod = jengine.VSUNet("fcmae", dict(TINY, fused_mlp=False), loss_function=loss or JMixedLoss(0.5, 0.0, 0.5),
                          **ENGINE, **kw)
    jmod.init_variables = lambda rng, batch: {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    return jmod


def _torch_engine(params, loss=None, **kw):
    tmod = tengine.VSUNet("fcmae", dict(TINY, fused_mlp=True), loss_function=loss or MixedLoss(0.5, 0.0, 0.5),
                          device="cpu", **ENGINE, **kw)
    load_flax_params(tmod.model, params)
    return tmod


def jax_fit(params, root, train, val=None, engine_kw=None, callbacks=(), **trainer_kw):
    jmod = _jax_engine(params, **(engine_kw or {}))
    trainer = JTrainer(default_root_dir=root, use_tensorboard=False, seed=0, checkpoint_every_n_epochs=NEVER,
                       callbacks=list(callbacks), **trainer_kw)
    trainer.fit(jmod, _Data(train, val))
    return trainer


def port_fit(params, root, train, val=None, engine_kw=None, callbacks=(), **trainer_kw):
    tmod = _torch_engine(params, **(engine_kw or {}))
    trainer_kw.setdefault("checkpoint_every_n_epochs", NEVER)
    trainer = Trainer(default_root_dir=root, seed=0, callbacks=list(callbacks), device="cpu", **trainer_kw)
    trainer.fit(tmod, _Data(train, val))
    return trainer, tmod


def _assert_params_match(jtrainer, tmod, frozen_unchanged_from=None):
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    for name, p in tmod.model.named_parameters():
        if name in UNBRIDGED:
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
        if frozen_unchanged_from is not None and name.startswith("encoder."):
            assert torch.equal(p.detach(), frozen_unchanged_from[name]), name

