"""The port's train step (VSUNet.training_loss, autograd through the fused
MLP+GRN Function, AdamW + WarmupCosine, Trainer.fit) against viscy_tpu.

A tiny FCMAE-UNeXt2 (blocks (1, 1, 2, 1), dims 16-128, depth 5, 1 -> 2
channels; the port runs ``fused_mlp=True``, the JAX side the unfused
blocks, which tests/test_fused_block.py pins equal to the fused ones) with
seeded JAX weights carried across by the weight bridge, and the flagship
loss ``MixedLoss(0.5, 0, 0.5)``. Tolerances, float32: loss to 1e-5
relative; every parameter gradient to 2e-3 of its range with Pearson
r > 0.9999 (the torch-parity bound); parameters after two steps to 1e-5
absolute, 1 % of the learning rate (AdamW's update m / (sqrt(v) + eps)
turns a gradient difference of 1e-9 on an element whose gradient is near
eps into a visible fraction of a step of size lr = 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training.losses.mixed_loss import MixedLoss as JMixedLoss
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.data.gpu_aug import DeviceTransformDataModule
from viscy_tpu_torch.ops import fused_block as tfb
from viscy_tpu_torch.training.callbacks.base import Callback
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss
from viscy_tpu_torch.training.trainer import Trainer

from _torch_port_helpers import assert_rel_close, flax_params

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


def _batch(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return {
        "source": rng.random((n, 1, 5, 64, 64), np.float32),
        "target": rng.random((n, 2, 5, 64, 64), np.float32),
    }


@pytest.fixture(scope="module")
def setup():
    params = flax_params(JFCMAE(**TINY), 31, jnp.zeros((1, 1, 5, 64, 64)))
    jmod = jengine.VSUNet("fcmae", dict(TINY, fused_mlp=False),
                          loss_function=JMixedLoss(0.5, 0.0, 0.5), **ENGINE)

    @jax.jit
    def value_and_grad(p, batch):
        def loss_fn(p):
            return jmod.training_loss({"params": p}, batch, jax.random.PRNGKey(0))[0]

        return jax.value_and_grad(loss_fn)(p)

    return params, jmod, value_and_grad


def _torch_engine(params):
    tmod = tengine.VSUNet("fcmae", dict(TINY, fused_mlp=True), loss_function=MixedLoss(0.5, 0.0, 0.5),
                          device="cpu", **ENGINE)
    load_flax_params(tmod.model, params)
    return tmod


def test_training_loss_and_every_gradient_match_jax(setup):
    params, _, value_and_grad = setup
    batch = _batch()
    jloss, jgrads = value_and_grad(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tmod = _torch_engine(params)
    loss = tmod.training_loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tmod.model.named_parameters()}
    assert set(got) - set(want) == UNBRIDGED
    for name, w in want.items():
        assert got[name] is not None, name
        assert_rel_close(got[name].numpy(), w.numpy(), 2e-3, 0.9999)


class _InMemory(DeviceTransformDataModule):
    def __init__(self, batch, steps):
        self.batch, self.steps, self.stages = batch, steps, []

    def setup(self, stage):
        self.stages.append(stage)

    def train_dataloader(self):
        return [self.batch] * self.steps


class _Losses(Callback):
    def __init__(self):
        self.events = []

    def on_fit_start(self, trainer, module):
        self.events.append("start")

    def on_train_batch_end(self, trainer, module, metrics, batch, batch_idx):
        self.events.append((batch_idx, float(metrics["loss/train"])))

    def on_fit_end(self, trainer, module):
        self.events.append("end")


def test_two_fit_steps_match_two_jax_steps(setup, tmp_path):
    params, jmod, value_and_grad = setup
    batch = _batch(seed=1)
    tx, sched = jmod.configure_optimizers(total_steps=2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses = []
    for _ in range(2):
        loss, grads = value_and_grad(jp, jbatch)
        upd, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        jlosses.append(float(loss))

    tmod = _torch_engine(params)
    before = {n: p.detach().clone() for n, p in tmod.model.named_parameters()}
    rec = _Losses()
    dm = _InMemory(batch, steps=5)
    trainer = Trainer(max_steps=2, callbacks=[rec], log_every_n_steps=1, default_root_dir=tmp_path,
                      device="cpu")
    trainer.fit(tmod, dm)
    assert dm.stages == ["fit"] and trainer.global_step == 2
    assert rec.events[0] == "start" and rec.events[-1] == "end"
    np.testing.assert_allclose([e[1] for e in rec.events[1:-1]], jlosses, rtol=1e-5)
    assert trainer.logged_metrics["lr"] == pytest.approx(float(sched(2)), rel=1e-6, abs=1e-9)
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in tmod.model.named_parameters():
        if name in UNBRIDGED:
            assert torch.equal(p.detach(), before[name])
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
        assert not torch.equal(p.detach(), before[name]), name


def test_fit_runs_the_device_transform_with_the_seeded_generator(tmp_path):
    """Trainer.fit hands the datamodule's device transform its generator
    (seeded with seed + 1) at every step; no kernel launches on the CPU."""
    from viscy_tpu_torch.transforms import BatchedRandGaussianNoised, Compose

    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=2, n=1).items()}
    seen = []

    class Spy(DeviceTransformDataModule):
        train_device_transforms = Compose([BatchedRandGaussianNoised(keys=["source"], prob=1.0)])

        def train_dataloader(self):
            return [batch] * 3

        def device_transform(self, b, generator, stage="train"):
            seen.append((stage, generator.initial_seed()))
            return super().device_transform(b, generator, stage)

    tmod = tengine.VSUNet("fcmae", dict(TINY), device="cpu", lr=1e-4)
    before = (tfb.launches, tfb.bwd_launches)
    trainer = Trainer(max_epochs=1, seed=7, default_root_dir=tmp_path, device="cpu")
    trainer.fit(tmod, Spy())
    assert seen == [("train", 8)] * 3 and trainer.global_step == 3
    assert (tfb.launches, tfb.bwd_launches) == before
