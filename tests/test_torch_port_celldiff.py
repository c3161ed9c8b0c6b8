"""CELLDiff's modules, the shared 3-D U-Net base and FNet3D in the port
against viscy_tpu.

Inputs and weights are numpy-seeded (every leaf drawn, so the adaLN-Zero
weights are away from their zero init and the ViT blocks are not the
identity); weights reach the port through the port's flax bridges. The JAX
references run under ``jax.jit``. Random draws (the training times and
noise, the SDE's noise) are the JAX package's, handed to the port.
Tolerances (float32): network outputs and BatchNorm statistics within
2e-3 of the range with Pearson r > 0.9999 (the repo's torch-parity bound,
``tests/test_torch_parity.py:50-51``); the path coefficients, losses and
samplers within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.models.celldiff import celldiff_net as jnet
from viscy_tpu.models.celldiff import paths as jpaths
from viscy_tpu.models.celldiff import transport as jtransport
from viscy_tpu.models.celldiff import vit_bottleneck as jvit
from viscy_tpu.models.components import conv_blocks as jconv
from viscy_tpu.models.unet import unet3d as junet3d
from viscy_tpu.models.unet import unet3d_base as jbase
from viscy_tpu_torch.models.celldiff import celldiff_net as tnet
from viscy_tpu_torch.models.celldiff import paths as tpaths
from viscy_tpu_torch.models.celldiff import transport as ttransport
from viscy_tpu_torch.models.celldiff import vit_bottleneck as tvit
from viscy_tpu_torch.models.components import conv_blocks as tconv
from viscy_tpu_torch.models.unet import unet3d as tunet3d
from viscy_tpu_torch.models.unet import unet3d_base as tbase
from viscy_tpu_torch.training.convert import (
    celldiff_state_dict_from_flax,
    load_flax_params,
    unet3d_state_dict_from_flax,
)

from _torch_port_helpers import assert_rel_close, flax_params

# narrow stand-ins for configs/celldiff_fit.yml's net_config (dims 64-256,
# hidden 512, 8 heads of 64, 8 layers, patch 4)
VIT = dict(hidden_size=32, num_heads=2, num_hidden_layers=2, patch_size=2, dim_head=16)
NET = dict(in_channels=1, out_channels=1, dims=(8, 16, 16), num_res_block=(1, 2), **VIT)
SHAPE = (2, 1, 4, 16, 16)


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got: torch.Tensor, want, rel=2e-3) -> None:
    assert_rel_close(got.detach().numpy(), np.asarray(want), rel, 0.9999)


def _jit(module, variables, *args, **static):
    call = lambda v, *a: module.apply(v, *a, **static)
    return jax.jit(call)(jax.tree_util.tree_map(jnp.asarray, variables), *args)


def _gen():
    return torch.Generator().manual_seed(0)


def _load_sub(module: torch.nn.Module, params: dict, where: str, prefix: str) -> None:
    """Load the flax subtree ``params`` placed at ``unet/<where>`` into
    ``module``, whose keys are the bridge's with ``prefix`` removed."""
    tree = {"unet": {}}
    node = tree["unet"]
    *parents, leaf = where.split("/")
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = params
    state = {k[len(prefix):]: v for k, v in celldiff_state_dict_from_flax(tree, VIT["patch_size"]).items()
             if k.startswith(prefix)}
    module.load_state_dict(state, strict=True)


def _cl(x: np.ndarray) -> jnp.ndarray:
    """NCDHW -> the JAX blocks' channels-last."""
    return jnp.asarray(np.moveaxis(x, 1, -1))


# -- blocks ----------------------------------------------------------------------------------------


@pytest.mark.parametrize("timed", [True, False], ids=["time", "no_time"])
def test_resnet_block_matches_jax(timed):
    """Channels 8 -> 16 (the 1x1 ``res_conv``), group norm, SiLU; with time
    the FiLM between block1's norm and its activation."""
    x = _x((2, 8, 4, 8, 8), 1)
    temb = _x((2, 32), 2)
    jmod = jconv.ResnetBlock(16, time_emb_dim=32 if timed else None)
    args = (_cl(x), jnp.asarray(temb) if timed else None)
    params = flax_params(jmod, 3, *args)
    want = np.moveaxis(np.asarray(_jit(jmod, {"params": params}, *args)), -1, 1)
    tmod = tconv.ResnetBlock(8, 16, _gen(), time_emb_dim=32 if timed else None)
    _load_sub(tmod, params, "enc0_0", "_encoder_blocks.0.0.")
    assert (tmod.mlp is not None) == timed and tmod.res_conv is not None
    got = tmod(torch.from_numpy(x), torch.from_numpy(temb) if timed else None)
    _close(got, want)


def test_timestep_embedder_matches_jax():
    t = np.random.default_rng(4).random(5).astype(np.float32)
    jmod = jconv.TimestepEmbedder(32)
    params = flax_params(jmod, 5, jnp.asarray(t))
    want = _jit(jmod, {"params": params}, jnp.asarray(t))
    tmod = tconv.TimestepEmbedder(32, _gen())
    _load_sub(tmod, params, "time_embedder", "_time_embedder.")
    _close(tmod(torch.from_numpy(t)), want)


# -- the U-Net base --------------------------------------------------------------------------------


@pytest.mark.parametrize("downsample_z", [False, True], ids=["yx", "zyx"])
def test_unet3d_base_matches_jax(downsample_z):
    """Conditioned and timed base with the identity bottleneck, in both Z
    modes (the transposed convs' (1, 3, 3) and 3^3 kernels)."""
    cfg = dict(in_channels=1, out_channels=2, dims=(8, 16, 16), num_res_block=(1, 2), downsample_z=downsample_z,
               time_embed_dim=32, cond_channels=1)
    x, cond, t = _x(SHAPE, 6), _x(SHAPE, 7), np.array([0.3, 0.8], np.float32)
    jmod = jbase.UNet3DBase(bottleneck_factory=jbase.IdentityBottleneck, **cfg)
    args = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))
    params = flax_params(jmod, 8, *args)
    want = _jit(jmod, {"params": params}, *args)
    tmod = tbase.UNet3DBase(bottleneck=tbase.IdentityBottleneck(), generator=_gen(), **cfg)
    up = tmod._upsamples[0].weight
    assert tuple(up.shape) == ((16, 16, 3, 3, 3) if downsample_z else (16, 16, 1, 3, 3))
    tmod.load_state_dict(unet3d_state_dict_from_flax({"unet": params}), strict=True)
    got = tmod(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t))
    assert got.shape == (2, 2, 4, 16, 16)
    _close(got, want)


def test_unet3d_base_divisibility_checks():
    base = lambda **kw: tbase.UNet3DBase(1, 1, generator=_gen(), bottleneck=tbase.IdentityBottleneck(), **kw)
    with pytest.raises(ValueError, match=r"len\(dims\) must equal len\(num_res_block\) \+ 1"):
        base(dims=(8, 16), num_res_block=(1, 1))
    net = base(dims=(8, 16, 16), num_res_block=(1, 1))
    with pytest.raises(ValueError, match="Spatial dim H=18 must be divisible by 4"):
        net(torch.zeros(1, 1, 3, 18, 16))
    net(torch.zeros(1, 1, 3, 16, 16))  # Z is not downsampled: any depth
    zyx = base(dims=(8, 16, 16), num_res_block=(1, 1), downsample_z=True)
    with pytest.raises(ValueError, match="Spatial dim D=3 must be divisible by 4"):
        zyx(torch.zeros(1, 1, 3, 16, 16))


# -- the ViT bottleneck ----------------------------------------------------------------------------


def test_sincos_pos_embed_equals_jax():
    np.testing.assert_array_equal(tvit.get_3d_sincos_pos_embed(32, (2, 3, 4)),
                                  jvit.get_3d_sincos_pos_embed(32, (2, 3, 4)))
    with pytest.raises(ValueError, match="divisible by 16"):
        tvit.get_3d_sincos_pos_embed(24, (1, 1, 1))


@pytest.mark.parametrize("conditioned", [True, False], ids=["adaLN", "plain"])
def test_vit_bottleneck_matches_jax(conditioned):
    """Cubic patches, positions, two blocks (adaLN-Zero weights drawn away
    from zero when conditioned), the final layer and the unpatchify."""
    x, temb = _x((2, 16, 4, 4, 6), 9), _x((2, 32), 10)
    jmod = jvit.ViTBottleneck3D(16, conditioned=conditioned, **VIT)
    args = (_cl(x), jnp.asarray(temb) if conditioned else None)
    params = flax_params(jmod, 11, *args)
    assert ("final_adaLN" in params) == conditioned
    want = np.moveaxis(np.asarray(_jit(jmod, {"params": params}, *args)), -1, 1)
    tmod = tvit.ViTBottleneck3D(16, _gen(), conditioned=conditioned, **VIT)
    _load_sub(tmod, params, "bottleneck", "bottleneck.")
    got = tmod(torch.from_numpy(x), torch.from_numpy(temb) if conditioned else None)
    _close(got, want)
    with pytest.raises(ValueError, match="Latent W dimension 5 is not divisible by patch_size=2"):
        tmod(torch.zeros(1, 16, 4, 4, 5))
    with pytest.raises(NotImplementedError, match="dropout"):
        tvit.ViTBottleneck3D(16, _gen(), dropout=0.1)


# -- whole networks --------------------------------------------------------------------------------


def test_celldiff_net_matches_jax():
    x, cond, t = _x(SHAPE, 12), _x(SHAPE, 13), np.array([0.1, 0.7], np.float32)
    jmod = jnet.CELLDiffNet(cond_channels=1, **NET)
    args = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))
    params = flax_params(jmod, 14, *args)
    want = _jit(jmod, {"params": params}, *args)
    tmod = tnet.CELLDiffNet(cond_channels=1, **NET)
    load_flax_params(tmod, params)
    _close(tmod(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t)), want)


def test_unet_vit3d_matches_jax():
    x = _x(SHAPE, 15)
    jmod = jnet.UNetViT3D(**NET)
    params = flax_params(jmod, 16, jnp.asarray(x))
    want = _jit(jmod, {"params": params}, jnp.asarray(x))
    tmod = tnet.UNetViT3D(**NET)
    load_flax_params(tmod, params)
    assert not any("adaLN" in k or "mlp" in k for k in tmod.state_dict())
    _close(tmod(torch.from_numpy(x)), want)


def test_unet3d_train_mode_and_running_statistics_match_jax():
    """FNet3D (batch norm, ReLU, non-residual, Z downsampled) in train mode:
    the output, then every BatchNorm's running mean and (biased) variance
    after the step."""
    cfg = dict(depth=2, mult_chan=8, in_stack_depth=4)
    x = _x(SHAPE, 17)
    jmod = junet3d.Unet3d(**cfg)
    params = flax_params(jmod, 18, jnp.asarray(x))
    rng = np.random.default_rng(19)
    stats = jax.tree_util.tree_map(lambda s: rng.random(s.shape).astype(np.float32) + 0.5,
                                   jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))["batch_stats"])
    call = lambda v, a: jmod.apply(v, a, deterministic=False, mutable=["batch_stats"])
    want, new = jax.jit(call)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    tmod = tunet3d.Unet3d(**cfg)
    load_flax_params(tmod, params, stats)
    tmod.train()
    got = tmod(torch.from_numpy(x))
    _close(got, want)
    after = unet3d_state_dict_from_flax(params, jax.tree_util.tree_map(np.asarray, new["batch_stats"]))
    state = tmod.state_dict()
    running = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert len(running) == 2 * 2 * (2 * 2 + 1)  # mean and var of two norms a block, 5 blocks
    for k in running:
        assert_rel_close(state[k].numpy(), after[k].numpy(), 2e-3, 0.9999)
    assert all(int(v) == 1 for k, v in state.items() if k.endswith("num_batches_tracked"))


def test_batch_norm_keeps_float64_statistics_for_a_float64_input():
    """flax promotes a batch's statistics to at least float32 and keeps a
    float64 input's in float64: FNet3D's norm in train mode on an f64 input
    whose mean dwarfs its spread equals the f64 formula (the statistics
    rounded to f32 are off by about 2e-4 of range here)."""
    x = torch.from_numpy(np.random.default_rng(23).normal(10.0, 0.1, (2, 8, 3, 6, 6)))
    norm = tconv.norm_layer("batch", 8).double().train()
    got = norm(x).detach()
    mean = x.mean(dim=(0, 2, 3, 4), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3, 4), keepdim=True)
    want = (x - mean) / torch.sqrt(var + 1e-5)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-9 * float(want.max() - want.min())
    assert torch.allclose(norm.running_mean, 0.1 * mean.flatten(), rtol=1e-12, atol=0)


# -- paths and transport ---------------------------------------------------------------------------


def _rel(got, want, tol=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


PLANS = {"linear": ("ICPlan", {}), "vp": ("VPCPlan", {}), "gvp": ("GVPCPlan", {})}
DIFFUSIONS = ("constant", "SBDM", "sigma", "linear", "decreasing", "increasing-decreasing")


@pytest.mark.parametrize("plan", list(PLANS))
def test_path_coefficients_match_jax(plan):
    name, kw = PLANS[plan]
    jp, tp = getattr(jpaths, name)(**kw), getattr(tpaths, name)(**kw)
    t = np.array([0.05, 0.3, 0.62, 0.97], np.float32)
    x, v = _x((4, 2, 3, 5), 20), _x((4, 2, 3, 5), 21)
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    jx, tx, jv, tv = jnp.asarray(x), torch.from_numpy(x), jnp.asarray(v), torch.from_numpy(v)
    for fn in ("compute_alpha_t", "compute_sigma_t"):
        for g, w in zip(getattr(tp, fn)(tt), getattr(jp, fn)(jt)):
            _rel(g, w)
    _rel(tp.compute_d_alpha_alpha_ratio_t(tt), jp.compute_d_alpha_alpha_ratio_t(jt))
    for g, w in zip(tp.compute_drift(tx, tt), jp.compute_drift(jx, jt)):
        _rel(g, np.broadcast_to(w, np.broadcast_shapes(np.shape(w), np.shape(g))) if np.ndim(w) else w)
    for form in DIFFUSIONS:
        g, w = tp.compute_diffusion(tx, tt, form=form, norm=0.7), jp.compute_diffusion(jx, jt, form=form, norm=0.7)
        _rel(g, w)
    for fn in ("get_score_from_velocity", "get_score_from_denoised", "get_noise_from_velocity",
               "get_velocity_from_score"):
        _rel(getattr(tp, fn)(tv, tx, tt), getattr(jp, fn)(jv, jx, jt))
    for g, w in zip(tp.plan(tt, tx, tv), jp.plan(jt, jx, jv)):
        _rel(g, w)
    with pytest.raises(NotImplementedError):
        tp.compute_diffusion(tx, tt, form="cubic")


TRANSPORTS = [(path, pred, weight) for path in ("Linear", "GVP", "VP")
              for pred in ("velocity", "noise", "score", "denoised")
              for weight in (None, "velocity", "likelihood")]


def _field(x, t):
    """A smooth nonlinear stand-in for a network's output."""
    mod = jnp if isinstance(x, jnp.ndarray) else torch
    t = t.reshape((-1,) + (1,) * (x.ndim - 1))
    return mod.tanh(x) * (1.0 - t) + 0.3 * mod.sin(3.0 * x) * t + 0.1


@pytest.mark.parametrize("path,pred,weight", TRANSPORTS)
def test_training_losses_match_jax_with_its_draws(path, pred, weight):
    """``create_transport``'s intervals, ``training_losses`` per sample and
    ``training_loss``, with the times and noise the JAX transport drew from
    its key; ``interpolate``, ``get_drift`` and ``get_score`` beside them."""
    kw = dict(path_type=path, prediction=pred, loss_weight=weight, t_sampler="logit-normal")
    jtr, ttr = jtransport.create_transport(**kw), ttransport.create_transport(**kw)
    assert (ttr.train_eps, ttr.sample_eps) == (jtr.train_eps, jtr.sample_eps)
    for sde in (False, True):
        assert ttr.check_interval(0.01, 0.02, sde=sde, is_eval=True, last_step_size=0.04) == \
            jtr.check_interval(0.01, 0.02, sde=sde, is_eval=True, last_step_size=0.04)
    x1 = _x((3, 1, 2, 4, 4), 22)
    key = jax.random.PRNGKey(23)
    jt, jx0, _ = jtr.sample(key, jnp.asarray(x1))
    t, x0 = torch.from_numpy(np.array(jt)), torch.from_numpy(np.array(jx0))
    _, jxt, jut = jtr.path_sampler.plan(jt, jx0, jnp.asarray(x1))
    _, xt, ut = ttr.path_sampler.plan(t, x0, torch.from_numpy(x1))
    want = jtr.training_losses(_field(jxt, jt), jx0, jnp.asarray(x1), jxt, jut, jt)["loss"]
    got = ttr.training_losses(_field(xt, t), x0, torch.from_numpy(x1), xt, ut, t)["loss"]
    _rel(got, want)
    _rel(ttr.training_loss(_field, torch.from_numpy(x1), t=t, x0=x0), jtr.training_loss(_field, jnp.asarray(x1), key))
    for g, w in zip(ttr.interpolate(x0, torch.from_numpy(x1), t), jtr.interpolate(jx0, jnp.asarray(x1), jt)):
        _rel(g, w)
    tmid = torch.full((3,), 0.4)
    _rel(ttr.get_drift()(xt, tmid, _field), jtr.get_drift()(jxt, jnp.full((3,), 0.4), _field))
    _rel(ttr.get_score()(xt, tmid, _field), jtr.get_score()(jxt, jnp.full((3,), 0.4), _field))


def test_transport_draws_and_refusals():
    tr = ttransport.create_transport()
    g = torch.Generator().manual_seed(0)
    t, x0, _ = tr.sample(torch.zeros(6, 1, 2, 3, 3), g)
    assert t.shape == (6,) and x0.shape == (6, 1, 2, 3, 3) and bool(((t >= 0) & (t <= 1)).all())
    _rel(tr.prior_logp(x0), jtransport.Transport().prior_logp(jnp.asarray(x0.numpy())))
    for kw, msg in ((dict(path_type="linear"), "path_type"), (dict(prediction="flow"), "prediction"),
                    (dict(loss_weight="l1"), "loss_weight")):
        with pytest.raises(ValueError, match=msg):
            ttransport.create_transport(**kw)


def test_samplers_match_jax_from_a_fixed_start():
    """Euler and Heun from the same ``x0``; the SDE with the noise the JAX
    sampler drew (its key split once a step)."""
    x0 = _x((2, 1, 2, 4, 4), 24)
    jx0, tx0 = jnp.asarray(x0), torch.from_numpy(x0)
    _rel(ttransport.euler_sampler(_field, tx0, 7), jax.jit(lambda a: jtransport.euler_sampler(_field, a, 7))(jx0))
    _rel(ttransport.heun_sampler(_field, tx0, 5), jax.jit(lambda a: jtransport.heun_sampler(_field, a, 5))(jx0))
    key, noise, k = jax.random.PRNGKey(25), [], jax.random.PRNGKey(25)
    for _ in range(6):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, x0.shape, jnp.float32)))
    want = jax.jit(lambda a: jtransport.sde_sampler(_field, a, key, 6, diffusion=0.4))(jx0)
    got = ttransport.sde_sampler(_field, tx0, num_steps=6, diffusion=0.4, noise=torch.from_numpy(np.stack(noise)))
    _rel(got, want)
    drawn = ttransport.sde_sampler(_field, tx0, torch.Generator().manual_seed(1), num_steps=6)
    assert drawn.shape == tx0.shape and bool(torch.isfinite(drawn).all())
