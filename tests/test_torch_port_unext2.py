"""UNeXt2 (the released VSCyto3D architecture) in the port against
viscy_tpu.

Inputs and weights are numpy-seeded (GRN gamma/beta non-zero); weights
reach the port through ``unext2_state_dict_from_flax``. The JAX references
run under ``jax.jit`` (its unfused modules: the same math as the fused
kernel's plain version the port runs on the CPU). JAX threefry and torch
Philox draw different numbers, so the drop-path keep masks JAX drew (read
off its ``DropPath`` outputs) are handed to the port. Tolerances (float32,
TF32 off): outputs and every gradient within 2e-3 of the range with
Pearson r > 0.9999 (the repo's torch-parity bound); the head's single PReLU
slope gradient to 2e-3 relative; losses to 1e-5 relative.
"""

import re

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.models.components import heads as jheads
from viscy_tpu.models.components import stems as jstems
from viscy_tpu.models.components.blocks import DropPath as JDropPath
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.models.unet.unext2 import UNeXt2 as JUNeXt2
from viscy_tpu.training.convert import convert_unext2_state_dict
from viscy_tpu.training import state_dict_inventory as inventory
from viscy_tpu.training.state_dict_inventory import released_inventory, unext2_state_dict_inventory
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.models.components.heads import PixelToVoxelHead
from viscy_tpu_torch.models.components.stems import UNeXt2Stem
from viscy_tpu_torch.models.unet.fcmae import FullyConvolutionalMAE
from viscy_tpu_torch.models.unet.unext2 import UNeXt2
from viscy_tpu_torch.training.convert import load_flax_params, unext2_state_dict_from_flax

from _torch_port_helpers import assert_rel_close, flax_params

TINY = dict(in_channels=1, out_channels=1, in_stack_depth=5, backbone="convnextv2_test",
            stem_kernel_size=(5, 4, 4), decoder_conv_blocks=1)
VSCYTO3D = dict(in_channels=1, out_channels=2, in_stack_depth=5, backbone="convnextv2_tiny",
                stem_kernel_size=(5, 4, 4), decoder_conv_blocks=2)


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _x(shape, seed):
    return np.random.default_rng(seed).random(shape, np.float32)


def _close(got: torch.Tensor, want, rel=2e-3) -> None:
    assert_rel_close(got.detach().numpy(), np.asarray(want), rel, 0.9999)


def _jit_apply(module: nn.Module, params: dict, *args, rngs=None, **static):
    call = lambda p, r, *a: module.apply({"params": p}, *a, rngs=rngs and r, **static)
    return jax.jit(call)(jax.tree_util.tree_map(jnp.asarray, params), rngs, *args)


def _port(cfg: dict, params: dict, cls=UNeXt2) -> torch.nn.Module:
    model = cls(**cfg)
    load_flax_params(model, params)
    return model


def _sub_state(module: torch.nn.Module, params: dict, part: str) -> None:
    """Load the flax subtree of one top-level part into the port's part."""
    state = {k[len(part) + 1:]: v for k, v in unext2_state_dict_from_flax({part: params}).items()}
    module.load_state_dict(state, strict=True)


# -- state dict and bridge ----------------------------------------------------------------


@pytest.mark.parametrize("which", ["test", "atto", "vscyto3d"])
def test_state_dict_equals_reference_inventory(which, monkeypatch):
    # the inventory's backbone table has no test width: give it the port's
    monkeypatch.setitem(inventory.BACKBONES, "convnextv2_test", ((1, 1, 2, 1), (16, 32, 64, 128), True))
    if which == "vscyto3d":
        model, inv = UNeXt2(**VSCYTO3D), released_inventory("vscyto3d")
    else:
        cfg = dict(TINY, backbone="convnextv2_test" if which == "test" else "convnextv2_atto")
        model = UNeXt2(**cfg)
        inv = unext2_state_dict_inventory(**cfg)
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v) for k, v in inv.items()}
    assert all(v.dtype == torch.float32 for v in sd.values())


@pytest.mark.parametrize("backbone", ["convnextv2_test", "convnext_test"])
def test_bridge_round_trips_bit_for_bit(backbone):
    """flax -> port (strict) -> ``convert_unext2_state_dict`` -> flax: every leaf
    back bit for bit, the v1 layer scales included."""
    cfg = dict(TINY, backbone=backbone)
    params = flax_params(JUNeXt2(**cfg), 3, jnp.zeros((1, 1, 5, 64, 64)))
    model = _port(cfg, params)
    back = convert_unext2_state_dict({k: v.numpy() for k, v in model.state_dict().items()})

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out.update(flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
        return out

    orig, got = flat(params), flat(back)
    # the JAX converter's UNeXt2 rules carry no v1 layer scale (the released
    # UNeXt2 is v2): those leaves alone do not come back
    scales = {k for k in orig if k.endswith("ls_gamma")}
    assert bool(scales) == (backbone == "convnext_test")
    assert set(got) == set(orig) - scales
    for k, v in got.items():
        np.testing.assert_array_equal(v, orig[k], err_msg=k)
    for k in scales:
        stage, block = re.fullmatch(r"encoder/stage(\d+)/block(\d+)/ls_gamma", k).groups()
        gamma = model.encoder_stages.get_submodule(f"stages_{stage}.blocks.{block}").gamma
        np.testing.assert_array_equal(gamma.detach().numpy(), orig[k])


# -- parts ------------------------------------------------------------------------------------


def test_stem_matches_jax():
    jmod = jstems.UNeXt2Stem(2, 24, (5, 4, 4), 10)
    x = _x((2, 2, 10, 32, 32), 1)
    params = flax_params(jmod, 2, jnp.asarray(x))
    want = _jit_apply(jmod, params, jnp.asarray(x))
    tmod = UNeXt2Stem(2, 24, torch.Generator().manual_seed(0), (5, 4, 4), 10)
    _sub_state(tmod, params, "stem")
    got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 8, 8, 24)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        UNeXt2Stem(1, 25, torch.Generator(), (5, 4, 4), 10)


@pytest.mark.parametrize("pool", [False, True])
def test_pixel_to_voxel_head_matches_jax(pool):
    """2x shuffle (blurred with ``pool``), the (D + 2) fold, conv0, the
    eps-1e-6 instance norm, PReLU, conv1, the per-slice shuffle."""
    jmod = jheads.PixelToVoxelHead(in_channels=112, out_channels=2, out_stack_depth=5, expansion_ratio=2, pool=pool)
    x = np.random.default_rng(4).normal(0, 1, (2, 6, 5, 112)).astype(np.float32)
    params = flax_params(jmod, 5, jnp.asarray(x))
    params["conv0_prelu"] = np.array([0.3], np.float32)
    want = _jit_apply(jmod, params, jnp.asarray(x))
    tmod = PixelToVoxelHead(112, 2, 5, torch.Generator().manual_seed(0), expansion_ratio=2, pool=pool)
    _sub_state(tmod, params, "head")
    got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 2, 5, 24, 20) and got.dtype == torch.float32
    _close(got, want)


# -- the whole model ---------------------------------------------------------------------------


FORWARD_CASES = {
    "v2": {},
    "head_pool": dict(head_pool=True),
    "out_depth_3": dict(out_stack_depth=3),
    "v1": dict(backbone="convnext_test"),
    "depth_10": dict(in_stack_depth=10, in_channels=2, out_channels=2),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case):
    cfg = dict(TINY, **FORWARD_CASES[case])
    jmod = JUNeXt2(**cfg)
    x = _x((2, cfg["in_channels"], cfg["in_stack_depth"], 64, 96), 6)
    params = flax_params(jmod, 7, jnp.asarray(x))
    want = _jit_apply(jmod, params, jnp.asarray(x))
    got = _port(cfg, params)(torch.from_numpy(x))
    out_depth = cfg.get("out_stack_depth", cfg["in_stack_depth"])
    assert got.shape == (2, cfg["out_channels"], out_depth, 64, 96)
    _close(got, want)


def test_stack_depth_not_divisible_by_the_stem_raises():
    with pytest.raises(ValueError, match="not divisible by stem kernel depth"):
        UNeXt2(**dict(TINY, in_stack_depth=7))


def test_every_gradient_matches_jax():
    """MSE of the forward against a target: the loss and every parameter
    gradient against ``jax.grad``."""
    cfg = dict(TINY, out_channels=2)
    jmod = JUNeXt2(**cfg)
    x, y = _x((2, 1, 5, 64, 64), 8), _x((2, 2, 5, 64, 64), 9)
    params = flax_params(jmod, 10, jnp.asarray(x))

    def loss_fn(p):
        return jnp.mean(jnp.square(jmod.apply({"params": p}, jnp.asarray(x)) - jnp.asarray(y)))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree_util.tree_map(jnp.asarray, params))
    model = _port(cfg, params)
    loss = torch.mean(torch.square(model(torch.from_numpy(x)) - torch.from_numpy(y)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = unext2_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        if w.numel() == 1:  # the PReLU slope
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3, err_msg=name)
        elif name == "head.conv.0.conv.bias":
            # a bias under a non-affine instance norm: 0 up to rounding on both sides
            scale = np.abs(got["head.conv.0.conv.weight"].grad.numpy()).max()
            assert np.abs(g.numpy()).max() < 1e-5 * scale and np.abs(w.numpy()).max() < 1e-5 * scale
        else:
            assert_rel_close(g.numpy(), w.numpy(), 2e-3, 0.9999)


def test_drop_path_with_jax_draws_matches_jax():
    """Training forward at drop path 0.5: the keep masks JAX drew for its
    active blocks (all but the first, whose rate is 0) handed to the port;
    some branches dropped, some kept. The v2 blocks run the kernel on the
    branch alone, then the mask and the residual."""
    cfg = dict(TINY, drop_path_rate=0.5)
    jmod = JUNeXt2(**cfg)
    x = _x((4, 1, 5, 64, 64), 11)
    params = flax_params(jmod, 12, jnp.asarray(x))
    outs = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JDropPath) and context.module.rate > 0 and context.method_name == "__call__":
            outs.append(out)
        return out

    def fwd(p, rng):
        with nn.intercept_methods(record):
            y = jmod.apply({"params": p}, jnp.asarray(x), deterministic=False, rngs={"dropout": rng})
        return y, outs

    want, drawn = jax.jit(fwd)(jax.tree_util.tree_map(jnp.asarray, params), jax.random.PRNGKey(3))
    keeps = [torch.from_numpy(np.asarray(o).reshape(o.shape[0], -1).any(axis=1)) for o in drawn]
    flat = torch.cat(keeps)
    assert len(keeps) == sum((1, 1, 2, 1)) - 1 and flat.any() and not flat.all()
    model = _port(cfg, params).train()
    _close(model(torch.from_numpy(x), drop_path_masks=keeps), want)
    with pytest.raises(ValueError, match="Generator or a keep mask"):
        model(torch.from_numpy(x))
    # eval mode: no drop path, the deterministic JAX forward
    _close(model.eval()(torch.from_numpy(x)), _jit_apply(jmod, params, jnp.asarray(x)))


@pytest.mark.parametrize("tile", [None, (64, 64)], ids=["full_frame", "tiled"])
def test_predict_step_on_a_non_divisible_frame_matches_jax(tile):
    """``VSUNet("UNeXt2").predict_step``: the full frame padded to a multiple
    of 2^6 (as the reference) and cropped back; tiles padded to the total
    stride, blended."""
    cfg = dict(TINY)
    params = flax_params(JUNeXt2(**cfg), 13, jnp.zeros((1, 1, 5, 64, 64)))
    jmod = jengine.VSUNet("UNeXt2", dict(cfg), tile_yx=tile, tile_batch=4)
    source = _x((1, 1, 5, 80, 100), 14)
    want = jax.jit(lambda p, s: jmod.predict_step({"params": p}, {"source": s}))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(source))
    tmod = tengine.VSUNet("UNeXt2", dict(cfg), tile_yx=tile, tile_batch=4, device="cpu").eval()
    load_flax_params(tmod.model, params)
    assert "pretraining" not in tmod.model_config
    assert tmod.model.num_blocks == 6 and tmod.model.total_stride == 32
    with torch.no_grad():
        got = tmod.predict_step({"source": torch.from_numpy(source)})
    assert got.shape == (1, 1, 5, 80, 100)
    _close(got, want)


def test_fcmae_head_conv_forward_matches_jax():
    """FCMAE with ``head_conv=True`` (PixelToVoxelHead sized by in_channels,
    as the reference) against JAX."""
    cfg = dict(in_channels=1, out_channels=2, encoder_blocks=(1, 1, 1, 1), dims=(16, 32, 64, 128),
               stem_kernel_size=(5, 4, 4), in_stack_depth=5, decoder_conv_blocks=1, pretraining=False,
               head_conv=True)
    jmod = JFCMAE(**cfg)
    x = _x((2, 1, 5, 64, 64), 15)
    params = flax_params(jmod, 16, jnp.asarray(x))
    want = _jit_apply(jmod, params, jnp.asarray(x))
    got = _port(cfg, params, FullyConvolutionalMAE)(torch.from_numpy(x))
    assert got.shape == (2, 2, 5, 64, 64)
    _close(got, want)
