"""The legacy U-Nets (``ConvBlock``, ``Unet2d``, ``Unet25d``) and
``VSUNet("2D" | "2.5D")`` in the port against viscy_tpu.

Inputs, weights and BatchNorm statistics are numpy-seeded and reach the
port through its flax bridges; the JAX references run under ``jax.jit``.
Dropout keep masks are JAX's, read off its ``Dropout`` outputs
(``capture_intermediates``) and handed to the port in call order.
Tolerances (float32, TF32 off): outputs, losses, gradients and running
statistics within 2e-3 of the range with Pearson r > 0.9999; the
upsampling pin within 1e-6 of the range.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as fnn

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.models.components import conv_blocks as jconv
from viscy_tpu.models.unet.unet2d import Unet2d as JUnet2d
from viscy_tpu.models.unet.unet25d import Unet25d as JUnet25d
from viscy_tpu.training import convert as jconvert
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.models.components import conv_blocks as tconv
from viscy_tpu_torch.models.unet.unet2d import Unet2d, upsample_yx
from viscy_tpu_torch.models.unet.unet25d import Unet25d
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.convert import (
    load_flax_params,
    state_dict_from_flax,
    unet2d_state_dict_from_flax,
    unet25d_state_dict_from_flax,
)
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_helpers import assert_rel_close, flax_params

ROOT = Path(__file__).resolve().parents[1]
# narrow stand-ins for the JAX defaults (filters 16 * 2**i over 4 blocks)
U2D = dict(in_channels=1, out_channels=2, num_blocks=2, num_filters=(4, 8, 16), task="reg")
U25D = dict(in_channels=1, out_channels=2, in_stack_depth=5, out_stack_depth=1, num_blocks=2,
            num_filters=(4, 8, 16), task="reg")


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _x(shape, seed, lo=None):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) if lo is not None else rng.normal(0, 1, shape)).astype(np.float32)


def _close(got, want, rel=2e-3) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert_rel_close(got, np.asarray(want), rel, 0.9999)


def _stats(shapes, seed: int) -> dict:
    """Seeded BatchNorm statistics for a ``batch_stats`` shape tree: means
    N(0, 0.1), variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    walk = lambda n: {k: walk(v) if isinstance(v, dict) else (
        rng.normal(0, 0.1, v.shape) if k == "mean" else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        for k, v in sorted(n.items())}
    return walk(shapes)


def _variables(jmod, x, seed: int) -> dict:
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    out = {"params": flax_params(jmod, seed, jnp.asarray(x))}
    if "batch_stats" in shapes:
        out["batch_stats"] = _stats(shapes["batch_stats"], seed + 1)
    return out


def _dropout_masks(inter: dict, order: list[str]) -> list[torch.Tensor]:
    """JAX's dropout keep masks (output != 0), channels first, in ``order``
    of the blocks, each block's ``Dropout_{i}`` in turn."""
    masks = []
    for block in order:
        node = inter.get(block, {})
        for name in sorted(k for k in node if k.startswith("Dropout_")):
            out = np.asarray(node[name]["__call__"][0])
            masks.append(torch.from_numpy(np.moveaxis(out != 0, -1, 1).copy()))
    return masks


def _jax_train(jmod, variables, x, target, key_seed=7, **kw):
    """JAX's train-mode MSE loss, its parameter gradients, the updated
    BatchNorm statistics and the dropout outputs, under jit."""

    def loss_fn(params):
        pred, upd = jmod.apply({**variables, "params": params}, x, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(key_seed)},
                               mutable=["batch_stats", "intermediates"],
                               capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout), **kw)
        return jnp.mean((pred - target) ** 2), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), grads, upd


def _check_grads(model, grads_flax, bridge) -> int:
    want = bridge(grads_flax)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == {n for n, g in got.items() if g is not None}
    for name, w in want.items():
        _close(got[name], w.numpy())
    return len(want)


def _check_running(model, stats_flax, bridge) -> None:
    want = bridge(stats_flax)
    state = model.state_dict()
    assert want
    for name, w in want.items():
        _close(state[name], w.numpy())


# -- ConvBlock -----------------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["batch", "instance", "group", "none"])
@pytest.mark.parametrize("channels", [(16, 8), (8, 16), (16, 16)], ids=["shrink", "grow", "same"])
def test_conv_block_matches_jax(norm, channels):
    """Residual rules (1x1 ``resid_conv`` when channels shrink, low-side zero
    pad when they grow, identity when equal) under every norm, eval mode,
    at an even kernel (XLA SAME pads it asymmetrically)."""
    cin, cout = channels
    x = _x((2, cin, 9, 10), 1)
    jmod = jconv.ConvBlock(cout, kernel_size=(3, 2), num_repeats=2, residual=True, norm=norm)
    xl = jnp.asarray(np.moveaxis(x, 1, -1))
    v = _variables(jmod, xl, 2)
    want = np.moveaxis(np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, False))(v, xl)), -1, 1)
    tmod = tconv.ConvBlock2D(cin, cout, torch.Generator().manual_seed(0), kernel_size=(3, 2), norm=norm).eval()
    assert (tmod.resid_conv is not None) == (cin > cout)
    # the block's tree under a level's name, through the port's bridge
    state = unet2d_state_dict_from_flax({"down_conv_block0": v["params"]},
                                        {"down_conv_block0": v["batch_stats"]} if "batch_stats" in v else None)
    tmod.load_state_dict({k.split(".", 1)[1]: t for k, t in state.items()}, strict=False)
    missing = set(tmod.state_dict()) - {k.split(".", 1)[1] for k in state}
    assert missing <= {f"batch_norm_{i}.num_batches_tracked" for i in range(2)}
    _close(tmod(torch.from_numpy(x)), want)


def test_conv_block_train_step_with_dropout_and_batch_statistics():
    """3-D block, channels growing, dropout 0.3 (JAX's masks), train-mode
    BatchNorm: output, gradients and the running statistics after it."""
    x = _x((2, 4, 5, 8, 8), 3)
    target = _x((2, 8, 5, 8, 8), 4)
    jmod = jconv.ConvBlock(8, kernel_size=(3, 3, 3), dropout=0.3)
    xl, tl = jnp.asarray(np.moveaxis(x, 1, -1)), jnp.asarray(np.moveaxis(target, 1, -1))
    v = _variables(jmod, xl, 5)

    def loss_fn(params):
        out, upd = jmod.apply({**v, "params": params}, xl, True, rngs={"dropout": jax.random.PRNGKey(3)},
                              mutable=["batch_stats", "intermediates"],
                              capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout))
        return jnp.mean((out - tl) ** 2), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    masks = _dropout_masks({"b": upd["intermediates"]}, ["b"])
    assert len(masks) == 2 and 0.6 < float(masks[0].float().mean()) < 0.8
    tmod = tconv.ConvBlock3D(4, 8, torch.Generator().manual_seed(0), dropout=0.3).train()
    to_t = lambda tree, **k: {n.split(".", 1)[1]: t for n, t in
                              unet25d_state_dict_from_flax({"down_conv_block0": tree}, **k).items()}
    tmod.load_state_dict({**to_t(v["params"]), **to_t(v["params"], batch_stats={"down_conv_block0": v["batch_stats"]})},
                         strict=False)
    out = tmod(torch.from_numpy(x), masks=iter(masks))
    t_loss = ((out - torch.from_numpy(target)) ** 2).mean()
    t_loss.backward()
    assert abs(float(t_loss) - float(loss)) <= 2e-5 * abs(float(loss))
    want_g = to_t(grads)
    for name, p in tmod.named_parameters():
        _close(p.grad, want_g[name].numpy())
    want_s = to_t(v["params"], batch_stats={"down_conv_block0": upd["batch_stats"]})
    for name in ("batch_norm_0.running_mean", "batch_norm_1.running_var"):
        _close(tmod.state_dict()[name], want_s[name].numpy())


def test_dropout_draws_from_the_generator_at_the_keep_rate():
    x = torch.ones(4, 8, 32, 32)
    y = tconv.dropout(x, 0.25, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    with pytest.raises(ValueError, match="Generator"):
        tconv.dropout(x, 0.25)


# -- upsampling and the U-Nets -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 1, 3), (1, 2, 3, 5, 7)], ids=["odd", "thin", "depth"])
def test_upsampling_matches_jax_image_resize_at_the_edges(shape):
    """``jax.image.resize(..., "linear")`` at 2x against the port's bilinear
    (trilinear, depth kept) ``align_corners=False``: equal at every pixel,
    the edge rows and columns and odd sizes included."""
    x = _x(shape, 9)
    out_shape = (*shape[:-2], 2 * shape[-2], 2 * shape[-1])
    want = np.asarray(jax.jit(lambda a: jax.image.resize(a, out_shape, method="linear"))(jnp.asarray(x)))
    got = upsample_yx(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * (want.max() - want.min())
    edges = [(..., 0, slice(None)), (..., -1, slice(None)), (..., slice(None), 0), (..., slice(None), -1)]
    for e in edges:
        np.testing.assert_allclose(got[e], want[e], rtol=0, atol=1e-6)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("task", ["reg", "seg"])
def test_unet2d_forward_matches_jax(residual, task):
    cfg = dict(U2D, residual=residual, task=task)
    x = _x((2, 1, 1, 12, 20), 10)
    jmod = JUnet2d(**cfg)
    v = _variables(jmod, x, 11)
    want = jax.jit(lambda v, a: jmod.apply(v, a))(v, jnp.asarray(x))
    tmod = Unet2d(**cfg).eval()
    load_flax_params(tmod, v["params"], v["batch_stats"])
    got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 2, 1, 12, 20)
    _close(got, want)
    _close(tmod(torch.from_numpy(x[:, :, 0])), np.asarray(want)[:, :, 0])


def test_unet2d_train_step_matches_jax():
    """Train mode: dropout 0.2 (JAX's masks), batch statistics: the loss,
    every gradient and every running statistic after the step."""
    cfg = dict(U2D, residual=True)
    x, target = _x((2, 1, 1, 16, 16), 12), _x((2, 2, 1, 16, 16), 13)
    jmod = JUnet2d(**cfg)
    v = _variables(jmod, x, 14)
    loss, grads, upd = _jax_train(jmod, v, jnp.asarray(x), jnp.asarray(target))
    order = [f"down_conv_block{i}" for i in range(2)] + ["bottom_conv_block"] + \
        [f"up_conv_block{i}" for i in range(2)] + ["terminal_block"]
    masks = _dropout_masks(upd["intermediates"], order)
    assert len(masks) == 11
    tmod = Unet2d(**cfg).train()
    load_flax_params(tmod, v["params"], v["batch_stats"])
    t_loss = ((tmod(torch.from_numpy(x), dropout_masks=masks) - torch.from_numpy(target)) ** 2).mean()
    t_loss.backward()
    assert abs(float(t_loss) - loss) <= 2e-5 * loss
    assert _check_grads(tmod, grads, unet2d_state_dict_from_flax) > 20
    _check_running(tmod, upd["batch_stats"], lambda s: {k: t for k, t in unet2d_state_dict_from_flax(
        v["params"], s).items() if "running" in k})


@pytest.mark.parametrize("task", ["reg", "seg"])
def test_unet25d_forward_matches_jax(task):
    cfg = dict(U25D, task=task, residual=True)
    x = _x((2, 1, 5, 12, 20), 20)
    jmod = JUnet25d(**cfg)
    v = _variables(jmod, x, 21)
    want = jax.jit(lambda v, a: jmod.apply(v, a))(v, jnp.asarray(x))
    tmod = Unet25d(**cfg).eval()
    load_flax_params(tmod, v["params"], v["batch_stats"])
    got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 2, 1, 12, 20)
    _close(got, want)


@pytest.mark.parametrize("task", ["reg", "seg"])
def test_unet25d_train_step_matches_jax(task):
    """Train mode at ``out_stack_depth`` 2 (zk = 4): JAX's dropout masks,
    the loss, every gradient, the running statistics (the seg terminal
    block's batch norm and dropout included)."""
    cfg = dict(U25D, out_stack_depth=2, task=task)
    x, target = _x((2, 1, 5, 16, 16), 22), _x((2, 2, 2, 16, 16), 23)
    jmod = JUnet25d(**cfg)
    v = _variables(jmod, x, 24)
    loss, grads, upd = _jax_train(jmod, v, jnp.asarray(x), jnp.asarray(target))
    order = [f"down_conv_block{i}" for i in range(2)] + [f"up_conv_block{i}" for i in range(2)] + ["terminal_block"]
    masks = _dropout_masks(upd["intermediates"], order)
    assert len(masks) == 8 + (task == "seg")
    tmod = Unet25d(**cfg).train()
    load_flax_params(tmod, v["params"], v["batch_stats"])
    t_loss = ((tmod(torch.from_numpy(x), dropout_masks=masks) - torch.from_numpy(target)) ** 2).mean()
    t_loss.backward()
    assert abs(float(t_loss) - loss) <= 2e-5 * loss
    _check_grads(tmod, grads, unet25d_state_dict_from_flax)
    _check_running(tmod, upd["batch_stats"], lambda s: {k: t for k, t in unet25d_state_dict_from_flax(
        v["params"], s).items() if "running" in k})


# -- bridges -------------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["2D", "2.5D"])
def test_bridge_round_trips_bit_for_bit(arch):
    """flax -> the port's bridge -> the JAX package's converter -> flax, and
    the port's state_dict -> the JAX converter -> the port's bridge, both bit
    for bit (the residual projection and batch statistics included)."""
    jcls, tcls, conv = ((JUnet2d, Unet2d, jconvert.convert_unet2d_state_dict) if arch == "2D"
                        else (JUnet25d, Unet25d, jconvert.convert_unet25d_state_dict))
    cfg = dict(U2D if arch == "2D" else U25D, residual=True, num_filters=(8, 4, 16))
    x = _x((1, 1, 1 if arch == "2D" else 5, 16, 16), 30)
    v = _variables(jcls(**cfg), x, 31)
    tmod = tcls(**cfg)
    assert tmod.down_conv_block_1.resid_conv is not None  # 8 -> 4 shrinks
    state = state_dict_from_flax(tmod, v["params"], v["batch_stats"])
    params, stats = conv({k: t.numpy() for k, t in state.items()}, strip_prefix="")
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    for a, b in ((params, v["params"]), (stats, v["batch_stats"])):
        fa, fb = flat(a), flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert np.array_equal(np.asarray(fa[k]), fb[k]), k
    own = {k: t for k, t in tmod.state_dict().items() if not k.endswith("num_batches_tracked")}
    back = state_dict_from_flax(tmod, *conv({k: t.numpy() for k, t in own.items()}, strip_prefix=""))
    assert back.keys() == own.keys()
    assert all(torch.equal(back[k], own[k]) for k in own)


# -- the engine ----------------------------------------------------------------------------------


@pytest.mark.parametrize("extent,window", [(1, 5), (3, 5), (1, 2), (2, 7), (5, 5), (9, 5)])
def test_center_crop_follows_numpy_slice_clamping(extent, window):
    """A depth-1 (or shallower than the window) output: the crop is
    whatever numpy's slice rule makes of a negative start, as in JAX."""
    x = np.arange(2 * extent * 6, dtype=np.float32).reshape(1, 2, extent, 2, 3)
    want = np.asarray(jengine._center_crop_to_shape(jnp.asarray(x), (window, 2, 3)))
    got = tengine._center_crop_to_shape(torch.from_numpy(x), (window, 2, 3)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _engines(arch, cfg, x, seed):
    j = jengine.VSUNet(arch, dict(cfg))
    v = _variables(j.model, x, seed)
    t = tengine.VSUNet(arch, dict(cfg), device="cpu")
    load_flax_params(t.model, v["params"], v["batch_stats"])
    return j, v, t


@pytest.mark.parametrize("arch", ["2D", "2.5D"])
def test_vsunet_training_loss_and_predict_match_jax(arch):
    """``training_loss`` (MixedLoss, train-mode batch statistics; dropout 0
    so no random draw differs) and its running statistics, then
    ``predict_step`` on a window whose YX is not a multiple of
    ``2**num_blocks`` (divisible pad, forward, center crop, the 2.5-D
    output one deep)."""
    cfg = dict(U2D if arch == "2D" else U25D, dropout=0.0)
    depth = 1 if arch == "2D" else 5
    x, target = _x((2, 1, depth, 16, 16), 40, lo=0), _x((2, 2, 1, 16, 16), 41, lo=0)
    j, v, t = _engines(arch, cfg, x, 42)
    assert t.example_input()["source"].shape[2] == depth
    src = _x((1, 1, depth, 13, 21), 43)
    want = jax.jit(lambda v, s: j.predict_step(v, {"source": s}))(v, jnp.asarray(src))
    t.eval()
    with torch.no_grad():
        got = t.predict_step({"source": torch.from_numpy(src)})
    assert got.shape == (1, 2, 1, 13, 21)
    _close(got, want)
    batch = {"source": jnp.asarray(x), "target": jnp.asarray(target)}
    (loss, (_, upd)) = jax.jit(lambda v, b: j.training_loss(v, b, jax.random.PRNGKey(0)))(v, batch)
    t.train()
    t_loss = t.training_loss({k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()})
    assert abs(float(t_loss) - float(loss)) <= 2e-3 * abs(float(loss))
    _check_running(t.model, upd["batch_stats"], lambda s: {k: w for k, w in state_dict_from_flax(
        t.model, v["params"], s).items() if "running" in k})


def test_vsunet_registers_the_legacy_architectures():
    for arch, cls in (("2D", Unet2d), ("2.5D", Unet25d)):
        assert isinstance(tengine.VSUNet(arch, {"num_blocks": 1, "num_filters": [4, 8]}, device="cpu").model, cls)
    with pytest.raises(ValueError, match="not in"):
        tengine.VSUNet("3D", device="cpu")


# -- end to end ----------------------------------------------------------------------------------


def test_unet25d_fit_and_predict_through_the_cli(tmp_path):
    """``viscy-torch fit`` of a narrow ``VSUNet("2.5D")`` (dropout and
    batch norm on) from a seeded plate, then ``predict`` from ``last``: the
    depth-1 predictions land at each window's centre slice of the store."""
    channels = ["Phase3D", "Nucleus"]
    plate = build_hcs_plate(tmp_path / "plate.zarr", channels, zyx_shape=(7, 32, 32), num_timepoints=1,
                            rows=("A",), cols=("1",), fovs=("0", "1"), seed=3, norm_meta=True)
    model = {"class_path": "cytoland.engine.VSUNet",
             "init_args": {"architecture": "2.5D", "model_config": dict(U25D, out_channels=1, num_filters=[4, 8, 16],
                                                                          task="seg"),
                           "lr": 1e-3}}
    crop = {"class_path": "viscy_transforms.BatchedRandSpatialCropd",
            "init_args": {"keys": ["source", "target"], "roi_size": [-1, 16, 16]}}
    data = {"data_path": str(plate), "source_channel": "Phase3D", "target_channel": ["Nucleus"], "z_window_size": 5,
            "target_2d": True, "split_ratio": 0.5, "batch_size": 2, "num_workers": 0, "yx_patch_size": [16, 16],
            "augmentations": [crop], "val_augmentations": [crop]}
    root = tmp_path / "run"
    fit = {"model": model, "data": {"class_path": "viscy_data.HCSDataModule", "init_args": data},
           "trainer": {"device": "cpu", "max_epochs": 1, "default_root_dir": str(root), "log_every_n_steps": 1,
                       "limit_train_batches": 2, "limit_val_batches": 1}}
    (tmp_path / "fit.yml").write_text(yaml.safe_dump(fit))
    trainer = cli.main(["fit", "-c", str(tmp_path / "fit.yml")])
    assert trainer.global_step >= 1 and np.isfinite(trainer.logged_metrics["loss/validate"])
    store = tmp_path / "pred.zarr"
    pred = {"model": dict(model, init_args=dict(model["init_args"])),
            "data": {"class_path": "viscy_data.HCSDataModule",
                     "init_args": {"data_path": str(plate), "source_channel": "Phase3D", "target_channel": ["Nucleus"],
                                   "z_window_size": 5, "batch_size": 2, "num_workers": 0}},
            "trainer": {"device": "cpu", "callbacks": [{"class_path": "viscy_utils.callbacks.HCSPredictionWriter",
                                                        "init_args": {"output_store": str(store)}}]},
            "ckpt_path": str(root / "checkpoints" / "last")}
    (tmp_path / "pred.yml").write_text(yaml.safe_dump(pred))
    cli.main(["predict", "-c", str(tmp_path / "pred.yml")])
    out = open_ome_zarr(store)
    img = out["A/1/0"]["0"][:]
    # three 5-deep windows, one-deep outputs at their centre slices 2, 3, 4;
    # the writer grows the image to the last one it writes, as the JAX one does
    assert img.shape == (1, 1, 5, 32, 32)
    filled = [z for z in range(5) if np.abs(img[0, 0, z]).max() > 0]
    assert filled == [2, 3, 4] and np.isfinite(img).all()
