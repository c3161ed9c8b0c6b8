"""``DynacellGAN`` and the GAN models (``PatchGAN3D``,
``MultiScalePatchGAN3D``, flax-semantics spectral norm, the GAN losses and
R1 / R2) in the port against viscy_tpu.

Inputs, weights and spectral-norm ``u`` vectors are numpy-seeded and reach
the port through its flax bridges; the JAX references run under
``jax.jit``. Tolerances (float32, TF32 off): logits, features, losses,
penalties and every gradient within 2e-3 of the range with Pearson
r > 0.9999 (the conv biases an instance norm removes: 0 up to rounding on
both sides, below 1e-3 of their kernel's gradient; a gradient JAX gives as
exactly 0 must be 0; single values within 2e-3 of themselves); the spectral norm's ``u``, ``sigma`` and normalized
kernel within 1e-6 relative over several calls; scalar losses within
1e-5 relative; bridges and checkpoint restores bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as fnn

from viscy_tpu.apps.dynacell import engine as jdyn
from viscy_tpu.models import gan as jgan
from viscy_tpu.training.convert import convert_multiscale_patchgan3d_state_dict
from viscy_tpu_torch.apps.dynacell import engine as tdyn
from viscy_tpu_torch.models import gan as tgan
from viscy_tpu_torch.models.gan.patchgan3d import SpectralNormConv3d
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.convert import (
    fcmae_state_dict_from_flax,
    gan_state_dict_from_flax,
    load_flax_params,
    patchgan_state_dict_from_flax,
)
from viscy_tpu_torch.training.instantiate import resolve_class
from viscy_tpu_torch.training.trainer import Trainer, read_checkpoint
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_helpers import assert_rel_close, seeded_params

# narrow stand-ins: the FCMAE generator of configs/vscyto3d_fit.yml (dims
# 96-768, blocks 3-3-9-3, stem (5, 4, 4), depth 15) and the JAX default
# discriminator (base 64, 4 layers, 2 scales)
GEN = dict(in_channels=1, out_channels=2, encoder_blocks=(1, 1, 1, 1), dims=(8, 16, 32, 64), in_stack_depth=10,
           stem_kernel_size=(5, 4, 4), decoder_conv_blocks=1)
DISC = dict(base_channels=4)
SHAPE = (2, 10, 64, 64)
REGS = dict(r1_gamma=2.0, r2_gamma=1.0, r1_every=2, ema_kimg=0.01, lecam_gamma=0.5, lecam_decay=0.8)


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got, want, rel=2e-3) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert_rel_close(got, np.asarray(want), rel, 0.9999)


def _sn_stats(shapes, seed: int) -> dict:
    """Seeded spectral-norm statistics: ``u`` ~ N(0, 1), ``sigma`` 1."""
    rng = np.random.default_rng(seed)
    walk = lambda n: {k: walk(v) if isinstance(v, dict) else (
        rng.normal(0, 1, v.shape) if k == "u" else np.ones(v.shape)).astype(np.float32) for k, v in sorted(n.items())}
    return walk(shapes)


def _disc_vars(jmod, x, seed: int) -> dict:
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    return {"params": seeded_params(shapes["params"], seed), "batch_stats": _sn_stats(shapes["batch_stats"], seed + 1)}


def _tdisc(v, in_channels=3, **cfg):
    tmod = tgan.MultiScalePatchGAN3D(in_channels=in_channels, **dict(DISC, **cfg))
    tmod.load_state_dict(patchgan_state_dict_from_flax(v["params"], v["batch_stats"]), strict=True)
    return tmod


def _bias_under_norm(name: str) -> bool:
    """A conv bias an instance norm right after removes (layers 2 and up)."""
    parts = name.split(".")
    return parts[-1] == "bias" and parts[-2] == "0" and parts[-3] in ("layer2", "layer3", "layer4")


def _check_grads(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k]
        g = torch.zeros_like(w) if g is None else g  # a parameter the loss does not reach: JAX's 0
        if _bias_under_norm(k):
            scale = float(want[k[:-4] + "weight"].abs().max())
            assert float(g.abs().max()) < 1e-3 * scale and float(w.abs().max()) < 1e-3 * scale, k
        elif not float(w.abs().max()) > 0:
            # the last norm's shift moves R1 only through LeakyReLU's
            # piecewise-constant slope: exactly 0 in JAX, and here
            assert not float(g.abs().max()) > 0, k
        elif g.numel() == 1:
            assert abs(float(g.reshape(())) - float(w.reshape(()))) <= 2e-3 * abs(float(w.reshape(()))), k
        else:
            try:
                _close(g, w.numpy())
            except AssertionError as e:
                raise AssertionError(f"{k}: {e}") from None


# -- the discriminators --------------------------------------------------------------------------


@pytest.mark.parametrize("sn", [True, False], ids=["spectral", "plain"])
def test_patchgan3d_single_scale_matches_jax_with_features(sn):
    x = _x((2, 3, 10, 32, 32), 1)
    jmod = jgan.PatchGAN3D(base_channels=4, use_spectral_norm=sn)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": seeded_params(shapes["params"], 2)}
    if sn:
        v["batch_stats"] = _sn_stats(shapes["batch_stats"], 3)
    logits, feats = jax.jit(lambda v, a: jmod.apply(v, a, return_features=True))(v, jnp.asarray(x))
    tmod = tgan.PatchGAN3D(in_channels=3, base_channels=4, use_spectral_norm=sn)
    state = patchgan_state_dict_from_flax({"scale0": v["params"]}, {"scale0": v["batch_stats"]} if sn else None)
    tmod.load_state_dict({k.split(".", 2)[2]: t for k, t in state.items()}, strict=True)
    got, got_feats = tmod(torch.from_numpy(x), return_features=True)
    assert got.shape == (2, 1, 2, 1, 1) and len(got_feats) == 4
    _close(got, np.asarray(logits))
    for g, w in zip(got_feats, feats):
        _close(g, np.moveaxis(np.asarray(w), -1, 1))


def test_multiscale_patchgan3d_matches_jax_with_features():
    x = _x((2, 3, 10, 64, 64), 4)
    jmod = jgan.MultiScalePatchGAN3D(**DISC)
    v = _disc_vars(jmod, x, 5)
    logits, feats = jax.jit(lambda v, a: jmod.apply(v, a, return_features=True))(v, jnp.asarray(x))
    got, got_feats = _tdisc(v)(torch.from_numpy(x), return_features=True)
    assert [tuple(t.shape) for t in got] == [(2, 1, 2, 3, 3), (2, 1, 2, 1, 1)]
    for g, w in zip(got, logits):
        _close(g, np.asarray(w))
    for gs, ws in zip(got_feats, feats):
        for g, w in zip(gs, ws):
            _close(g, np.moveaxis(np.asarray(w), -1, 1))


def test_spectral_norm_sigma_and_u_follow_flax_over_several_calls():
    """flax's ``SpectralNorm``: one power iteration a call from the stored
    ``u``, ``u`` and ``sigma`` stored only with ``update_stats``. Five
    calls (updating, not, updating, updating, not): the output, ``u``,
    ``sigma`` and the normalized kernel after each, within 1e-6 relative;
    a call without ``update_stats`` leaves them bit for bit."""
    jmod = fnn.SpectralNorm(fnn.Conv(6, (4, 4, 4), strides=(1, 2, 2), padding=((1, 1),) * 3))
    x = _x((2, 8, 8, 8, 3), 6)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), update_stats=False))
    params = seeded_params(shapes["params"], 7)
    stats = _sn_stats(shapes["batch_stats"], 8)
    call = jax.jit(lambda v, a, up: jmod.apply(v, a, update_stats=up, mutable=["batch_stats"]), static_argnums=2)
    tmod = SpectralNormConv3d(3, 6, (4, 4, 4), (1, 2, 2), (1, 1, 1), torch.Generator().manual_seed(0))
    conv = next(iter(params.values()))
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(np.transpose(conv["kernel"], (4, 3, 0, 1, 2)).copy()))
        tmod.bias.copy_(torch.from_numpy(conv["bias"]))
        tmod.u.copy_(torch.from_numpy(stats["layer_instance/kernel/u"]))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    flat = lambda t: {k: t[f"layer_instance/kernel/{k}"] for k in ("u", "sigma")}
    for update in (True, False, True, True, False):
        before = tmod.u.clone(), tmod.sigma.clone()
        out, new = call({"params": params, "batch_stats": stats}, jnp.asarray(x), update)
        w = tmod.normalized_weight(update)
        got = torch.nn.functional.conv3d(xt, w, tmod.bias, (1, 2, 2), 1)
        tmod.commit()
        stats = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
        _close(got, np.moveaxis(np.asarray(out), -1, 1), rel=1e-6)
        np.testing.assert_allclose(tmod.u.numpy(), flat(stats)["u"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(tmod.sigma), float(flat(stats)["sigma"]), rtol=1e-6)
        want_w = np.transpose(conv["kernel"] / flat(stats)["sigma"], (4, 3, 0, 1, 2)) if update else None
        if update:
            np.testing.assert_allclose(w.detach().numpy(), want_w, rtol=1e-6, atol=1e-9)
        else:
            assert torch.equal(tmod.u, before[0]) and torch.equal(tmod.sigma, before[1])


def test_spectral_norm_iterates_in_eval_mode_and_commits_only_on_request():
    """Unlike torch's ``spectral_norm``: eval mode still iterates (the
    output is the same in both modes), and an ``update_stats`` call stores
    nothing until ``commit_stats``."""
    d = tgan.MultiScalePatchGAN3D(in_channels=2, base_channels=4)
    x = torch.randn(1, 2, 10, 64, 64, generator=torch.Generator().manual_seed(1))
    u0 = {k: t.clone() for k, t in d.state_dict().items() if k.endswith(".u")}
    with torch.no_grad():
        a = d.train()(x, update_stats=True)
        assert all(torch.equal(d.state_dict()[k], t) for k, t in u0.items())
        b = d.eval()(x)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    d.commit_stats()
    assert all(not torch.equal(d.state_dict()[k], t) for k, t in u0.items() if t.numel() > 1)


# -- losses --------------------------------------------------------------------------------------


def _logits(seed):
    return [_x((2, 1, 2, 3, 3), seed), _x((2, 1, 2, 1, 1), seed + 1)]


@pytest.mark.parametrize("mode", ["lsgan", "nonsat", "rpgan", "hinge"])
def test_gan_losses_match_jax(mode):
    real, fake = _logits(10), _logits(12)
    t = lambda xs: [torch.from_numpy(a) for a in xs]
    j = lambda xs: [jnp.asarray(a) for a in xs]
    np.testing.assert_allclose(float(tgan.gan_loss_d(t(real), t(fake), mode)),
                               float(jgan.gan_loss_d(j(real), j(fake), mode)), rtol=1e-5)
    np.testing.assert_allclose(float(tgan.gan_loss_g(t(fake), mode, real_logits=t(real))),
                               float(jgan.gan_loss_g(j(fake), mode, real_logits=j(real))), rtol=1e-5)


@pytest.mark.parametrize("name", ["lsgan_d_loss", "nonsat_d_loss", "rpgan_d_loss", "rpgan_g_loss", "lsgan_g_loss",
                                  "nonsat_g_loss"])
def test_reference_named_losses_match_jax(name):
    real, fake = _logits(20), _logits(22)
    args = (real, fake) if name.endswith("d_loss") or name.startswith("rpgan") else (fake,)
    got = getattr(tgan, name)(*[[torch.from_numpy(a) for a in xs] for xs in args])
    want = getattr(jgan, name)(*[[jnp.asarray(a) for a in xs] for xs in args])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="at least one scale"):
        getattr(tgan, name)(*([[]] * len(args)))


def test_feature_matching_lecam_and_mean_logit_match_jax():
    feats = [[_x((2, 4, 5, 8, 8), 30 + i) for i in range(3)], [_x((2, 4, 5, 4, 4), 40 + i) for i in range(3)]]
    other = [[_x(a.shape, 50 + i) for i, a in enumerate(s)] for s in feats]
    conv = lambda f, nest: [[f(a) for a in s] for s in nest]
    np.testing.assert_allclose(float(tgan.feature_matching_loss(conv(torch.from_numpy, feats),
                                                                conv(torch.from_numpy, other))),
                               float(jgan.feature_matching_loss(conv(jnp.asarray, feats), conv(jnp.asarray, other))),
                               rtol=1e-5)
    real, fake = _logits(60), _logits(62)
    t, j = (lambda xs: [torch.from_numpy(a) for a in xs]), (lambda xs: [jnp.asarray(a) for a in xs])
    np.testing.assert_allclose(float(tgan.lecam_penalty(t(real), t(fake), 0.3, -0.2)),
                               float(jgan.lecam_penalty(j(real), j(fake), 0.3, -0.2)), rtol=1e-5)
    np.testing.assert_allclose(float(tgan.mean_logit(t(real))), float(jgan.mean_logit(j(real))), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _penalty_inputs():
    x = _x((2, 3, 10, 64, 64), 70)
    jmod = jgan.MultiScalePatchGAN3D(**DISC)
    return x, jmod, _disc_vars(jmod, x, 71)


@pytest.mark.parametrize("which", ["r1_penalty", "r2_penalty"])
def test_r1_r2_values_and_their_gradients_match_jax(which):
    """The per-scale zero-centred penalty and its gradient in every
    discriminator parameter (a double backward through conv, instance
    norm, LeakyReLU, spectral norm and pooling)."""
    x, jmod, v = _penalty_inputs()

    def pen(params):
        return getattr(jgan, which)(lambda a: jmod.apply({**v, "params": params}, a), jnp.asarray(x))

    want, grads = jax.jit(jax.value_and_grad(pen))(v["params"])
    tmod = _tdisc(v)
    got = getattr(tgan, which)(lambda a: tmod(a), torch.from_numpy(x))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    want_g = patchgan_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    _check_grads({k: p.grad for k, p in tmod.named_parameters()}, want_g)


# -- the engine ----------------------------------------------------------------------------------


def _batch(seed=80):
    return {"source": _x((2, 1, *SHAPE[1:]), seed), "target": _x((2, 2, *SHAPE[1:]), seed + 1)}


@functools.lru_cache(maxsize=None)
def _jax_engine(mode: str, seed: int, kw: tuple):
    """The JAX engine and its seeded variables (generator, discriminator,
    ``u`` vectors, a non-trivial ``gan_state`` and EMA), built once a module
    for each configuration (``eval_shape`` of the init traces both
    networks)."""
    kw = dict(kw)
    j = jdyn.DynacellGAN(generator_config=dict(GEN), discriminator_config=dict(DISC), gan_mode=mode, **kw)
    jb = {k: jnp.asarray(a) for k, a in _batch().items()}
    shapes = jax.eval_shape(lambda: j.init_with_rngs({"params": jax.random.PRNGKey(0)}, jb))
    params = seeded_params(shapes["params"], seed)
    variables = {"params": params, "batch_stats": {"discriminator": _sn_stats(
        shapes["batch_stats"]["discriminator"], seed + 1)}}
    gs = {"d_step": np.int32(0), "lecam_real": np.float32(0.3), "lecam_fake": np.float32(-0.2)}
    if kw.get("ema_kimg") is not None:
        gs["ema_generator"] = seeded_params(shapes["params"]["generator"], seed + 2)
    variables["gan_state"] = gs
    return j, variables


def _engines(mode="lsgan", seed=90, **kw):
    """The JAX and a new port engine on the same seeded variables."""
    j, variables = _jax_engine(mode, seed, tuple(sorted(kw.items())))
    variables = dict(variables)
    t = tdyn.DynacellGAN(generator_config=dict(GEN), discriminator_config=dict(DISC), gan_mode=mode, device="cpu",
                         **kw)
    state = gan_state_dict_from_flax(t.model, variables)
    load_flax_params(t.model, variables["params"]["generator"])
    t.load_checkpoint_state(state)
    return j, t, variables, _batch()


@functools.lru_cache(maxsize=None)
def _jax_step(mode: str, kw: tuple):
    """``jax.jit`` of the JAX engine's loss and its parameter gradients, the
    other collections (``gan_state`` with ``d_step``) an argument: one trace
    serves every ``d_step``."""
    j, _ = _jax_engine(mode, 90, kw)

    def step(params, rest, batch):
        def loss_fn(p):
            return j.training_loss({**rest, "params": p}, batch, jax.random.PRNGKey(1))

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return jax.jit(step)


def test_gan_step_with_every_regularizer_matches_jax():
    """One step with R1, R2, LeCam and the EMA on, in the mode whose
    generator loss also reads the real logits (rpgan; every mode's losses
    are held by ``test_gan_losses_match_jax``): the total loss, every
    generator and discriminator gradient, the spectral-norm ``u`` after the
    step (advanced once, by the real batch's call), ``gan_state`` (d_step,
    the LeCam EMAs) and the EMA generator (from the pre-step parameters)."""
    j, t, v, b = _engines("rpgan", **REGS)
    jb = {k: jnp.asarray(a) for k, a in b.items()}
    rest = {k: x for k, x in v.items() if k != "params"}
    (loss, (metrics, upd)), grads = _jax_step("rpgan", tuple(sorted(REGS.items())))(v["params"], rest, jb)
    t.train()
    got = t.training_loss({k: torch.from_numpy(a) for k, a in b.items()})
    got.backward()
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    for k in ("loss/g_adv", "loss/g_fm", "loss/g_recon", "loss/d", "loss/r1", "loss/r2", "loss/d_total"):
        np.testing.assert_allclose(float(t.last_metrics[k]), float(metrics[k]), rtol=2e-4, err_msg=k)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    _check_grads({k: p.grad for k, p in t.discriminator.named_parameters()},
                 patchgan_state_dict_from_flax(grads["discriminator"]))
    g_want = fcmae_state_dict_from_flax(grads["generator"])
    for k, p in t.model.named_parameters():
        if k in g_want:
            _close(p.grad, g_want[k].numpy())
    after = gan_state_dict_from_flax(t.model, {"params": v["params"], "batch_stats": upd["batch_stats"],
                                               "gan_state": upd["gan_state"]})
    for k, w in after["discriminator"].items():
        if k.endswith((".u", ".sigma")):
            np.testing.assert_allclose(t.discriminator.state_dict()[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert t.d_step == int(after["gan_state"]["d_step"]) == 1
    for k in ("lecam_real", "lecam_fake"):
        np.testing.assert_allclose(float(getattr(t, k)), float(after["gan_state"][k]), rtol=1e-5)
    for k, w in after["ema_generator"].items():
        np.testing.assert_allclose(t.ema_generator[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_lazy_r1_applies_every_r1_every_steps():
    """d_step 1 of ``r1_every`` 2 (R1, R2, LeCam and the EMA on): no
    penalty on this step, as JAX's ``apply_reg`` of 0 (the loss equals the
    JAX loss at that d_step, from the jitted step of
    ``test_gan_step_with_every_regularizer_matches_jax``)."""
    j, t, v, b = _engines("rpgan", **REGS)
    rest = {k: x for k, x in v.items() if k != "params"}
    rest["gan_state"] = dict(rest["gan_state"], d_step=np.int32(1))
    t.d_step = 1
    (loss, _), _ = _jax_step("rpgan", tuple(sorted(REGS.items())))(
        v["params"], rest, {k: jnp.asarray(a) for k, a in b.items()})
    got = t.train().training_loss({k: torch.from_numpy(a) for k, a in b.items()})
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    assert "loss/r1" not in t.last_metrics and "loss/r2" not in t.last_metrics and t.d_step == 2


def test_each_network_gets_only_its_own_losses_gradient():
    """One backward of ``g_loss + d_loss``: the generator's gradients are
    exactly those of ``g_loss`` alone, the discriminator's exactly those of
    ``d_loss`` alone (the stop-gradients: detached discriminator
    parameters in the generator's calls, the detached prediction in the
    discriminator's)."""
    _, t, _, b = _engines("rpgan", **REGS)
    tb = {k: torch.from_numpy(a) for k, a in b.items()}
    t.train()
    state = {k: v.clone() for k, v in t.discriminator.state_dict().items()}
    g_params, d_params = list(t.model.parameters()), list(t.discriminator.parameters())

    def losses():
        t.discriminator.load_state_dict(state)
        t.d_step = 0
        g_loss, d_loss = t.adversarial_losses(tb)
        return g_loss + d_loss, g_loss, d_loss

    total, g_loss, d_loss = losses()
    assert t.last_metrics["loss/r1"] > 0
    grad = lambda y, ps: torch.autograd.grad(y, ps, allow_unused=True, retain_graph=True)
    g_of_d = grad(d_loss, g_params)
    d_of_g = grad(g_loss, d_params)
    assert all(g is None or not g.abs().max() > 0 for g in g_of_d)
    assert all(g is None or not g.abs().max() > 0 for g in d_of_g)
    total_g = grad(total, g_params + d_params)
    alone = grad(g_loss, g_params) + grad(d_loss, d_params)
    for a, w in zip(total_g, alone):
        assert (a is None and w is None) or torch.equal(a, w)


def test_predict_uses_the_ema_generator_as_jax():
    j, t, v, b = _engines("lsgan", ema_kimg=0.01)
    src = _x((1, 1, *SHAPE[1:]), 99)
    want = jax.jit(lambda v, s: j.predict_step(v, {"source": s}))(v, jnp.asarray(src))
    t.eval()
    with torch.no_grad():
        got = t.predict_step({"source": torch.from_numpy(src)})
        live = t.model(torch.from_numpy(src))
    _close(got, want)
    assert not torch.allclose(got, live)
    t.use_ema_at_predict = False
    with torch.no_grad():
        assert torch.equal(t.predict_step({"source": torch.from_numpy(src)}), live)
    # validation is the generator's L1
    vb = {"source": torch.from_numpy(b["source"]), "target": torch.from_numpy(b["target"])}
    with torch.no_grad():
        want_v, _ = jax.jit(lambda v, bb: j.validation_loss(v, bb, None))(
            v, {k: jnp.asarray(a) for k, a in b.items()})
        np.testing.assert_allclose(float(t.validation_loss(vb)), float(want_v), rtol=1e-5)


class _DataModule:
    def __init__(self, batches):
        self.batches = batches

    def setup(self, stage):
        pass

    def train_dataloader(self):
        return list(self.batches)

    def val_dataloader(self):
        return list(self.batches[:1])


def _gan(**kw):
    return tdyn.DynacellGAN(generator_config=dict(GEN), discriminator_config=dict(DISC), device="cpu", **kw)


def test_a_resume_restores_gan_state_u_and_the_ema(tmp_path):
    """A checkpoint carries the discriminator (``u``, ``sigma``), the EMA and
    ``gan_state``; a new engine resuming from it gets them bit for bit and
    steps on (d_step continues); the optimizer holds both groups (beta1
    0.5, ``lr_g`` / ``lr_d``)."""
    dm = _DataModule([_batch(s) for s in (1, 2)])
    first = _gan(lr_g=1e-3, lr_d=2e-3, **REGS)
    trainer = Trainer(max_epochs=1, device="cpu", default_root_dir=tmp_path / "run", use_tensorboard=False)
    trainer.fit(first, dm)
    groups = trainer.optimizer.param_groups
    assert [g["lr"] for g in groups] == [1e-3, 2e-3] and groups[0]["betas"][0] == 0.5
    assert first.d_step == 2
    ckpt = tmp_path / "run" / "checkpoints" / "last"
    payload, _ = read_checkpoint(ckpt)
    assert set(payload["engine_state"]) == {"discriminator", "gan_state", "ema_generator"}
    second = _gan(lr_g=1e-3, lr_d=2e-3, seed=7, **REGS)
    resumed = Trainer(max_epochs=2, device="cpu", default_root_dir=tmp_path / "run", use_tensorboard=False)
    resumed.load_checkpoint(ckpt, second)
    for k, t in first.discriminator.state_dict().items():
        assert torch.equal(second.discriminator.state_dict()[k], t), k
    for k, t in first.ema_generator.items():
        assert torch.equal(second.ema_generator[k], t), k
    assert second.d_step == 2 and torch.equal(second.lecam_real, first.lecam_real)
    resumed.optimizer = None
    resumed.fit(second, dm, ckpt_path=ckpt)
    assert second.d_step == 4 and resumed.global_step == 4


def test_every_generator_path_builds_with_a_matching_discriminator():
    """The FCMAE by default, a ``VSUNet`` architecture, ``"UNetViT3D"`` and a
    passed engine's model; the discriminator takes the generator's in + out
    channels whatever its config says."""
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.models.celldiff import UNetViT3D
    from viscy_tpu_torch.models.unet.fcmae import FullyConvolutionalMAE
    from viscy_tpu_torch.models.unet.unet3d import Unet3d

    vit = dict(in_channels=1, out_channels=1, dims=(8, 8), num_res_block=(1,), hidden_size=16, num_heads=1,
               dim_head=16, num_hidden_layers=1, patch_size=2)
    fnet = VSUNet("FNet3D", dict(depth=2, mult_chan=4, in_stack_depth=8), device="cpu")
    for gan, cls, chans in ((_gan(), FullyConvolutionalMAE, 3),
                            (tdyn.DynacellGAN("FNet3D", generator_config=dict(depth=2, mult_chan=4),
                                              discriminator_config=dict(DISC, in_channels=9), device="cpu"), Unet3d, 2),
                            (tdyn.DynacellGAN("UNetViT3D", generator_config=vit, device="cpu"), UNetViT3D, 2),
                            (tdyn.DynacellGAN(generator=fnet, device="cpu"), Unet3d, 2)):
        assert isinstance(gan.model, cls)
        assert gan.discriminator.in_channels == chans == gan.model.in_channels + gan.model.out_channels
    assert gan.model is fnet.model and gan.example_input()["source"].shape[2] == 8


def test_the_reference_class_paths_resolve_to_the_port():
    assert resolve_class("dynacell.engine.DynacellGAN") is tdyn.DynacellGAN
    assert resolve_class("viscy_models.gan.MultiScalePatchGAN3D") is tgan.MultiScalePatchGAN3D
    assert resolve_class("viscy_models.gan.patchgan3d.PatchGAN3D") is tgan.PatchGAN3D
    assert resolve_class("viscy_tpu.models.gan.losses.r1_penalty") is tgan.r1_penalty


def test_bridge_round_trips_bit_for_bit():
    """flax discriminator -> the port's bridge -> the JAX package's converter
    -> flax, bit for bit; the ``u`` vectors and ``sigma`` copied bit for
    bit; the engine's variables to its checkpoint state and back."""
    x = _x((1, 3, 10, 64, 64), 100)
    v = _disc_vars(jgan.MultiScalePatchGAN3D(**DISC), x, 101)
    state = patchgan_state_dict_from_flax(v["params"], v["batch_stats"])
    plain = {f"discriminator.{k}": t.numpy() for k, t in state.items() if not k.endswith((".u", ".sigma"))}
    back = convert_multiscale_patchgan3d_state_dict(plain)
    flat = lambda tr: dict(jax.tree_util.tree_flatten_with_path(tr)[0])
    fa, fb = flat(back), flat(v["params"])
    assert fa.keys() == fb.keys()
    assert all(np.array_equal(np.asarray(fa[k]), fb[k]) for k in fa)
    for s in range(2):
        for i, sn in enumerate(["SpectralNorm_0", "SpectralNorm_1", "SpectralNorm_2", "SpectralNorm_3"]):
            node = v["batch_stats"][f"scale{s}"][sn]
            for leaf in ("u", "sigma"):
                assert np.array_equal(state[f"discriminators.{s}.layer{i + 1}.0.{leaf}"].numpy(),
                                      node[f"conv{i + 1}/kernel/{leaf}"])
    _, t, variables, _ = _engines("lsgan", ema_kimg=0.01)
    own = t.checkpoint_state()
    want = gan_state_dict_from_flax(t.model, variables)
    assert all(torch.equal(own["discriminator"][k], w) for k, w in want["discriminator"].items())
    assert all(torch.equal(own["ema_generator"][k], w) for k, w in want["ema_generator"].items())


def test_gan_fit_and_predict_through_the_cli(tmp_path):
    """``viscy-torch fit`` of a narrow ``DynacellGAN`` (FCMAE generator, every
    regularizer on) from a seeded plate, a resume for a second epoch, then
    ``predict`` from ``last`` with the EMA generator: the store holds the
    EMA generator's prediction."""
    channels = ["Phase3D", "Nucleus", "Membrane"]
    plate = build_hcs_plate(tmp_path / "plate.zarr", channels, zyx_shape=(10, 64, 64), num_timepoints=1,
                            rows=("A",), cols=("1",), fovs=("0", "1"), seed=4, norm_meta=True)
    model = {"class_path": "dynacell.engine.DynacellGAN",
             "init_args": {"generator_config": {k: list(v) if isinstance(v, tuple) else v for k, v in GEN.items()},
                           "discriminator_config": DISC, **REGS}}
    data = {"data_path": str(plate), "source_channel": "Phase3D", "target_channel": ["Nucleus", "Membrane"],
            "z_window_size": 10, "split_ratio": 0.5, "batch_size": 1, "num_workers": 0, "yx_patch_size": [64, 64]}
    root = tmp_path / "run"
    fit = {"model": model, "data": {"class_path": "viscy_data.HCSDataModule", "init_args": data},
           "trainer": {"device": "cpu", "max_epochs": 1, "default_root_dir": str(root), "log_every_n_steps": 1}}
    (tmp_path / "fit.yml").write_text(yaml.safe_dump(fit))
    trainer = cli.main(["fit", "-c", str(tmp_path / "fit.yml")])
    assert trainer.global_step == 1 and np.isfinite(trainer.logged_metrics["loss/validate"])
    store = tmp_path / "pred.zarr"
    pred = {"model": model,
            "data": {"class_path": "viscy_data.HCSDataModule",
                     "init_args": {"data_path": str(plate), "source_channel": "Phase3D",
                                   "target_channel": ["Nucleus", "Membrane"], "z_window_size": 10, "batch_size": 1,
                                   "num_workers": 0}},
            "trainer": {"device": "cpu", "callbacks": [{"class_path": "viscy_utils.callbacks.HCSPredictionWriter",
                                                        "init_args": {"output_store": str(store)}}]},
            "ckpt_path": str(root / "checkpoints" / "last")}
    (tmp_path / "pred.yml").write_text(yaml.safe_dump(pred))
    cli.main(["predict", "-c", str(tmp_path / "pred.yml")])
    got = open_ome_zarr(store)["A/1/0"]["0"][:]
    module = _gan(**REGS)
    Trainer(device="cpu", use_tensorboard=False).load_checkpoint(root / "checkpoints" / "last", module)
    from viscy_tpu_torch.data.hcs import HCSDataModule

    dm = HCSDataModule(plate, "Phase3D", ["Nucleus", "Membrane"], 10, batch_size=1, num_workers=0)
    dm.setup("predict")
    batch = next(iter(dm.predict_dataloader()))
    with torch.no_grad():
        want = module.eval().predict_step({"source": torch.as_tensor(batch["source"])}).numpy()
    assert got.shape == (1, 2, 10, 64, 64)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6 * float(np.ptp(want)))
