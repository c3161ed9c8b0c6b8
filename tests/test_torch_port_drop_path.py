"""Stochastic depth in the port's FCMAE encoder against viscy_tpu.

A narrow FCMAE (blocks (1, 1, 2, 1), dims 16-128, depth 5, 1 -> 2
channels) with ``encoder_drop_path_rate`` 0.25, float32, TF32 off, with
seeded JAX weights carried across by the weight bridge. The JAX side trains
with ``deterministic=False`` (its unfused fallback); its per-block keep
masks are read off its ``DropPath`` outputs (a dropped sample's branch is
all zeros) and handed to the port, which runs the fused kernel on the
branch alone and applies the same masks. Loss to 1e-5 relative; every
parameter gradient to 2e-3 of its range with Pearson r > 0.9999 (the
repo's f32 bound). Rate 0 and eval mode: bit for bit today's forward."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.models.components.blocks import DropPath as JDropPath
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training.losses.mixed_loss import MixedLoss as JMixedLoss
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.models.components.blocks import DropPath
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss

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
    encoder_drop_path_rate=0.25,
)
UNBRIDGED = {"encoder.stem.conv2d.weight", "encoder.stem.conv2d.bias"}


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "source": rng.random((n, 1, 5, 64, 64), np.float32),
        "target": rng.random((n, 2, 5, 64, 64), np.float32),
    }


@pytest.fixture(scope="module")
def params():
    return flax_params(JFCMAE(**TINY), 41, jnp.zeros((1, 1, 5, 64, 64)))


def _torch_engine(params, **cfg):
    tmod = tengine.VSUNet("fcmae", dict(TINY, **cfg), loss_function=MixedLoss(0.5, 0.0, 0.5), device="cpu", lr=1e-3)
    load_flax_params(tmod.model, params)
    return tmod


def _jax_keep_masks(jmod, params, batch, rng):
    """Per-block (B,) keep masks of one JAX training forward, in block order."""
    outs = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        module = context.module
        if isinstance(module, JDropPath) and module.rate > 0 and context.method_name == "__call__":
            outs.append(np.asarray(out))
        return out

    with nn.intercept_methods(record):
        jmod.training_loss({"params": params}, batch, rng)
    return [o.reshape(o.shape[0], -1).any(axis=1) for o in outs]


def test_drop_path_loss_and_every_gradient_match_jax(params):
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jmod = jengine.VSUNet("fcmae", dict(TINY, fused_mlp=False), loss_function=JMixedLoss(0.5, 0.0, 0.5), lr=1e-3)
    rng = jax.random.PRNGKey(3)
    masks = _jax_keep_masks(jmod, jparams, jbatch, rng)
    assert len(masks) == sum(TINY["encoder_blocks"])
    flat = np.concatenate(masks)
    assert flat.any() and not flat.all()  # both kept and dropped samples occur

    jloss, jgrads = jax.jit(
        jax.value_and_grad(lambda p, b: jmod.training_loss({"params": p}, b, rng)[0])
    )(jparams, jbatch)
    tmod = _torch_engine(params).train()
    pred = tmod.model(torch.from_numpy(batch["source"]), drop_path_masks=[torch.from_numpy(m) for m in masks])
    loss = tmod._compute_loss(pred, torch.from_numpy(batch["target"]), batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tmod.model.named_parameters()}
    assert set(got) - set(want) == UNBRIDGED
    for name, w in want.items():
        assert got[name] is not None, name
        assert_rel_close(got[name].numpy(), w.numpy(), 2e-3, 0.9999)


def test_rate_zero_and_eval_mode_keep_the_single_fused_call(params):
    """Bit for bit: the eval-mode forward at rate 0.25, the training-mode
    forward at rate 0 (with a generator that it must not touch) and the
    eval-mode forward at rate 0."""
    x = torch.from_numpy(_batch(2, seed=1)["source"])
    with torch.no_grad():
        today = _torch_engine(params, encoder_drop_path_rate=0.0).eval().model(x)
        gen = torch.Generator().manual_seed(0)
        state = gen.get_state()
        train0 = _torch_engine(params, encoder_drop_path_rate=0.0).train().model(x, generator=gen)
        eval_dp = _torch_engine(params).eval().model(x)
    assert torch.equal(today, train0) and torch.equal(today, eval_dp)
    assert torch.equal(gen.get_state(), state)


def test_drop_path_draws_from_its_generator_only():
    """Keep masks come from the generator (the same seed gives the same
    masks and global RNG is not touched); the kept branch is divided by the
    keep probability rounded to the branch's dtype, as JAX divides a bf16
    array by a Python float."""
    dp = DropPath(0.1).train()
    x = torch.full((64, 3, 2), 1.0, dtype=torch.bfloat16)
    before = torch.random.get_rng_state()
    a = dp(x, torch.Generator().manual_seed(5))
    b = dp(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.equal(torch.random.get_rng_state(), before)
    kept = a[:, 0, 0] != 0
    assert 0 < int(kept.sum()) < 64
    want = float(jnp.ones((1,), jnp.bfloat16)[0] / 0.9)
    assert torch.all(a[kept] == want)
    with pytest.raises(ValueError, match="Generator"):
        dp(x)
    assert torch.equal(dp.eval()(x), x)
