"""viscy_tpu_torch FCMAE-UNeXt2 modules against their viscy_tpu counterparts.

Parameters come from ``seeded_params`` (numpy, GRN gamma/beta non-zero)
and reach the port through its weight bridge. Pure data movement (pixel
shuffle, pad-pool blur, head) must agree to 1e-6; float modules to the
repo's torch-parity bound, max|d| <= 2e-3 of the output range and Pearson
r > 0.9999 (``tests/test_torch_parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from viscy_tpu.models.components import blocks as jblocks
from viscy_tpu.models.components.heads import PixelToVoxelShuffleHead as JHead
from viscy_tpu.models.components.stems import MaskedAdaptiveProjection as JStem
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.ops.pallas import fused_block as jfb
from viscy_tpu_torch.models.components import blocks as tblocks
from viscy_tpu_torch.models.components.heads import PixelToVoxelShuffleHead
from viscy_tpu_torch.models.components.stems import MaskedAdaptiveProjection
from viscy_tpu_torch.models.unet.fcmae import FullyConvolutionalMAE
from viscy_tpu_torch.ops.fused_block import _grn_coeffs
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params

from _torch_port_helpers import NARROW, assert_rel_close, flax_params


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_matches_jax(r):
    x = _rand((2, 5, 3, 3 * r * r))
    got = tblocks.pixel_shuffle_2d(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(jblocks.pixel_shuffle_2d(jnp.asarray(x), r)))
    # torch nn.PixelShuffle channel order k = c*r^2 + i*r + j
    ref = torch.nn.PixelShuffle(r)(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("r", [1, 2, 4])
def test_pad_pool_blur_matches_jax(r):
    x = _rand((2, 9, 7, 3), seed=1)
    got = tblocks.pad_pool_blur_2d(torch.from_numpy(x), r).numpy()
    want = np.asarray(jblocks.pad_pool_blur_2d(jnp.asarray(x), r))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _port_sub_state(params, prefix):
    """Bridge a sub-module's flax params, placed where the FCMAE rules expect it."""
    tree = params
    for part in reversed(prefix.split(".")):
        tree = {part: tree}
    sd = fcmae_state_dict_from_flax(tree)
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


@pytest.mark.parametrize("depth", [15, 1], ids=["conv3d", "conv2d"])
def test_stem_matches_jax(depth):
    """15-deep input: conv3d with the c*3+d channel fold; 1 slice: conv2d."""
    x = _rand((2, 1, depth, 16, 12), seed=2)
    jstem = JStem(1, 24, kernel_size_2d=(4, 4), kernel_depth=5, in_stack_depth=15)
    params = flax_params(jstem, 3, jnp.asarray(x))
    want = np.asarray(jstem.apply({"params": params}, jnp.asarray(x)))
    stem = MaskedAdaptiveProjection(1, 24, torch.Generator().manual_seed(0), in_stack_depth=15)
    missing, unexpected = stem.load_state_dict(_port_sub_state(params, "encoder.stem"), strict=False)
    assert not unexpected and all(k.startswith(("conv2d", "conv3d")) for k in missing)
    got = stem(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 4, 3, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_head_matches_jax():
    x = _rand((2, 5, 4, 2 * 15 * 16), seed=4)
    jhead = JHead(in_channels=480, out_channels=2, out_stack_depth=15, xy_scaling=4, pool=True)
    want = np.asarray(jhead.apply({}, jnp.asarray(x)))
    head = PixelToVoxelShuffleHead(480, 2, out_stack_depth=15, xy_scaling=4, pool=True)
    got = head(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 15, 20, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_grn_and_layer_norm_match_flax():
    x = _rand((2, 6, 5, 32), seed=5)
    rng = np.random.default_rng(6)
    gamma, beta = rng.normal(0, 0.5, 32).astype(np.float32), rng.normal(0, 0.1, 32).astype(np.float32)
    want = np.asarray(jblocks.GRN(32).apply({"params": {"gamma": gamma, "beta": beta}}, jnp.asarray(x)))
    # the port runs the GRN inside fused_mlp_grn: its (B, M) glue on the
    # spatial sum of squares, then gamma * x * nx + beta + x
    grn = tblocks.GRN(32)
    with torch.no_grad():
        grn.weight.copy_(torch.from_numpy(gamma))
        grn.bias.copy_(torch.from_numpy(beta))
        xt = torch.from_numpy(x)
        _, _, nx = _grn_coeffs((xt * xt).sum(dim=(1, 2)), grn.eps)
        got = grn.weight * (xt * nx[:, None, None, :]) + grn.bias + xt
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    scale, bias = rng.normal(1, 0.1, 32).astype(np.float32), rng.normal(0, 0.1, 32).astype(np.float32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 1e-2)):
        ln = fnn.LayerNorm(epsilon=1e-6, dtype=jdt)
        want = np.asarray(ln.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)), np.float32)
        got = tblocks.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-6, tdt)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def narrow_case():
    """JAX narrow FCMAE on seeded params: unfused and fused (interpret) outputs."""
    x = _rand((2, 1, 15, 64, 64), seed=7)
    jm = JFCMAE(**NARROW)
    params = flax_params(jm, 8, jnp.asarray(x))
    unfused = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    prev, jfb.FORCE_INTERPRET = jfb.FORCE_INTERPRET, True
    try:
        fused = np.asarray(JFCMAE(**NARROW, fused_mlp=True).apply({"params": params}, jnp.asarray(x)))
    finally:
        jfb.FORCE_INTERPRET = prev
    return x, params, unfused, fused


@pytest.mark.parametrize("which", ["fused_interpret", "unfused"])
def test_fcmae_matches_jax_f32(narrow_case, which):
    x, params, unfused, fused = narrow_case
    model = FullyConvolutionalMAE(**NARROW)
    load_flax_params(model, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2, 15, 64, 64) and got.dtype == np.float32
    assert_rel_close(got, fused if which == "fused_interpret" else unfused, 2e-3, 0.9999)


def test_fcmae_bf16_tracks_jax_bf16(narrow_case):
    """bf16 end to end against the JAX bf16 model: rounding sites agree, so
    the outputs stay within 2e-2 of the range (r > 0.999); each side's bf16
    error vs f32 is itself about that size."""
    x, params, _, _ = narrow_case
    want = np.asarray(
        jax.jit(JFCMAE(**NARROW, dtype=jnp.bfloat16).apply)({"params": params}, jnp.asarray(x))
    )
    model = FullyConvolutionalMAE(**NARROW, dtype="bfloat16")
    load_flax_params(model, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert_rel_close(got.numpy(), want, 2e-2, 0.999)


def test_model_properties_match_jax():
    for cfg in (NARROW, dict(NARROW, dims=(96, 192, 384, 768), encoder_blocks=(3, 3, 9, 3))):
        jm = JFCMAE(**cfg)
        tm = FullyConvolutionalMAE(**cfg)
        assert (tm.num_blocks, tm.total_stride, tm.out_stack_depth) == (
            jm.num_blocks, jm.total_stride, jm.out_stack_depth
        )
