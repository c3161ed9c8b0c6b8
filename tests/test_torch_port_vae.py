"""The beta-VAEs (``BetaVae25D``, ``BetaVaeConv`` / ``BetaVaeMonai``),
``vae_loss``, ``cosine_anneal`` and ``BetaVaeModule`` in the port against
viscy_tpu, and a narrow ``viscy-torch fit`` / ``predict`` of the VAE from a
plate and its track CSVs.

Inputs and weights are numpy-seeded and reach the port through its VAE
bridge; the JAX references run under ``jax.jit``. The latent noise is
JAX's: ``eps = (z - mean) * exp(-logvar / 2)`` read off its training-mode
output and handed to the port. Tolerances (float32, TF32 off):
reconstructions, latents and every gradient within 2e-3 of the range with
Pearson r > 0.9999; scalar losses within 1e-5 relative (2e-5 through a
whole model); schedules exact.
"""

import csv
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from viscy_tpu.apps.dynaclr import vae_engine as jengine
from viscy_tpu.models import schedule as jschedule
from viscy_tpu.models.vae import beta_vae_25d as j25
from viscy_tpu.models.vae import beta_vae_conv as jconv
from viscy_tpu_torch.apps.dynaclr import vae_engine as tengine
from viscy_tpu_torch.models import schedule as tschedule
from viscy_tpu_torch.models.vae import BetaVae25D, BetaVaeConv, VaeOutput, vae_loss
from viscy_tpu_torch.models.vae.beta_vae_25d import VaeUpStage
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.callbacks import embedding_writer as tew
from viscy_tpu_torch.training.compose import load_composed_config
from viscy_tpu_torch.training.convert import load_flax_params, state_dict_from_flax, vae_state_dict_from_flax
from viscy_tpu_torch.training.instantiate import resolve_class
from viscy_tpu_torch.training.trainer import Trainer, read_checkpoint
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_helpers import assert_rel_close, flax_params

ROOT = Path(__file__).resolve().parents[1]
# narrow stand-ins for the BetaVae25D defaults (convnext_tiny, 2 channels,
# depth 16 -> 16, latent 1024, 256^2, stem (2, 4, 4), 4 decoder stages);
# TRAIN's (2, 8, 8) stem makes the reconstruction as large as the input
# (at the defaults it is twice the input: ``test_the_default_reconstruction
# _is_twice_the_input_in_both``)
VAE = dict(in_channels=2, in_stack_depth=8, out_stack_depth=8, latent_dim=16, input_spatial_size=(64, 64))
TRAIN = dict(VAE, stem_kernel_size=(2, 8, 8), stem_stride=(2, 8, 8))


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




def _vae25(backbone, cfg, seed):
    x = _x((2, 2, cfg["in_stack_depth"], *cfg["input_spatial_size"]), seed)
    jmod = j25.BetaVae25D(backbone=backbone, **cfg)
    params = flax_params(jmod, seed + 1, jnp.asarray(x))
    tmod = BetaVae25D(backbone=backbone, **cfg)
    load_flax_params(tmod, params)
    return jmod, tmod, params, x


def _jax_train(jmod, params, x, loss_fn=None):
    """JAX's training-mode output (its latent noise from key 5), the ELBO at
    beta 0.5 and its parameter gradients."""

    def f(p):
        out = jmod.apply({"params": p}, x, deterministic=False, rngs={"latent": jax.random.PRNGKey(5)})
        loss, _ = (loss_fn or j25.vae_loss)(out, x, beta=0.5)
        return loss, out

    (loss, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    eps = (np.asarray(out.z) - np.asarray(out.mean)) * np.exp(-0.5 * np.asarray(out.logvar))
    return float(loss), out, jax.tree_util.tree_map(np.asarray, grads), torch.from_numpy(eps.astype(np.float32))


# -- BetaVae25D ----------------------------------------------------------------------------------


@pytest.mark.parametrize("backbone", ["convnext_test", "convnextv2_test"], ids=["v1", "v2"])
def test_beta_vae_25d_forward_matches_jax(backbone):
    """Eval mode at the default stem (the reconstruction twice the input's
    YX, as in JAX): reconstruction, mean, logvar, z = mean."""
    jmod, tmod, params, x = _vae25(backbone, VAE, 1)
    want = jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, jnp.asarray(x))
    got = tmod.eval()(torch.from_numpy(x))
    assert got.recon_x.shape == (2, 2, 8, 128, 128) and got.mean.shape == (2, 16)
    for g, w in zip(got, want):
        _close(g, w)
    assert torch.equal(got.z, got.mean)


def test_beta_vae_25d_train_step_matches_jax_with_its_noise():
    """Training mode with JAX's ``eps`` (the v2 backbone; the v1 encoder's
    forward is held above): the sampled z, the ELBO and every gradient (the
    encoder's and the decoder's v2 stages through the fused block's plain
    version)."""
    jmod, tmod, params, x = _vae25("convnextv2_test", TRAIN, 2)
    loss, out, grads, eps = _jax_train(jmod, params, jnp.asarray(x))
    got = tmod.train()(torch.from_numpy(x), eps=eps)
    _close(got.z, out.z)
    t_loss, _ = vae_loss(got, torch.from_numpy(x), beta=0.5)
    t_loss.backward()
    assert abs(float(t_loss) - loss) <= 2e-5 * abs(loss)
    want = vae_state_dict_from_flax(tmod, grads)
    named = dict(tmod.named_parameters())
    assert set(want) == set(named)
    for k, w in want.items():
        if named[k].numel() == 1:  # the head's PReLU slope
            assert abs(float(named[k].grad) - float(w)) <= 2e-3 * abs(float(w)), k
        elif k == "head.conv.0.conv.bias":  # under the head's instance norm: 0 up to rounding
            assert float(named[k].grad.abs().max()) < 1e-3 * float(want["head.conv.0.conv.weight"].abs().max())
        else:
            _close(named[k].grad, w.numpy())


def test_vae_up_stage_at_scale_1_and_2_matches_jax():
    x = _x((2, 4, 4, 32), 3)
    for scale, out in ((2, 24), (1, 16)):
        jmod = j25.VaeUpStage(out, scale_factor=scale)
        params = flax_params(jmod, 4, jnp.asarray(x))
        want = jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, jnp.asarray(x))
        tmod = VaeUpStage(32, out, torch.Generator().manual_seed(0), scale_factor=scale)
        state = vae_state_dict_from_flax(BetaVae25D(**VAE), {"up0": params})
        tmod.load_state_dict({k[len("up0."):]: v for k, v in state.items()}, strict=True)
        _close(tmod(torch.from_numpy(x)), want)


def test_the_default_reconstruction_is_twice_the_input_in_both():
    """Every up stage upsamples by 2 (``scale_factor=2 if i < len(channels)``
    is always 2, copied from the JAX model), so at the default stem the
    reconstruction is twice the input's YX and ``vae_loss`` against the
    input raises in JAX and in the port alike; a (2, 8, 8) stem matches the
    sizes (the fault is in ``ROADMAP.md`` Queue 3)."""
    cfg = dict(VAE, backbone="convnextv2_test")
    x = _x((1, 2, 8, 64, 64), 5)
    jeng = jengine.BetaVaeModule(vae=dict(cfg))
    params = flax_params(jeng.model, 6, jnp.asarray(x))
    with pytest.raises((TypeError, ValueError)):
        jax.jit(lambda p, b: jeng.training_loss({"params": p}, b, jax.random.PRNGKey(0)))(params,
                                                                                           {"anchor": jnp.asarray(x)})
    teng = tengine.BetaVaeModule(vae=dict(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="must match"):
        teng.train().training_loss({"anchor": torch.from_numpy(x)}, eps=torch.zeros(1, 16))
    assert teng.model.train()(torch.from_numpy(x), eps=torch.zeros(1, 16)).recon_x.shape[-2:] == (128, 128)


# -- BetaVaeConv ---------------------------------------------------------------------------------


CONV_CASES = {
    "2d": dict(spatial_dims=2, in_shape=(1, 15, 13), out_channels=1, latent_size=8, channels=(4, 8), strides=(2, 2)),
    "3d-res": dict(spatial_dims=3, in_shape=(2, 5, 9, 10), out_channels=2, latent_size=8, channels=(4, 8, 8),
                   strides=((1, 2, 2), 2, 1), num_res_units=2, kernel_size=3, up_kernel_size=(3, 4, 4)),
    "sigmoid": dict(spatial_dims=2, in_shape=(1, 16, 16), out_channels=1, latent_size=4, channels=(3, 6),
                    strides=(2, 2), up_kernel_size=2, use_sigmoid=True, norm="batch"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_beta_vae_conv_matches_jax(case):
    """XLA-SAME strided convs (odd sizes), residual units with strided 1x1
    skips, transposed convs at strides with kernels below, at and above the
    stride, the crop back to ``in_shape``, instance norm at eps 1e-6 with a
    PReLU: eval forward, then a training step with JAX's eps (z, ELBO,
    every gradient; those of the conv biases an instance norm follows are 0
    up to rounding on both sides, below 1e-3 of their kernel's)."""
    cfg = CONV_CASES[case]
    x = np.abs(_x((2, *cfg["in_shape"]), 10)) if cfg.get("use_sigmoid") else _x((2, *cfg["in_shape"]), 10)
    jmod = jconv.BetaVaeConv(**cfg)
    params = flax_params(jmod, 11, jnp.asarray(x))
    tmod = BetaVaeConv(**cfg)
    load_flax_params(tmod, params)
    want = jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, jnp.asarray(x))
    got = tmod.eval()(torch.from_numpy(x))
    assert got.recon_x.shape == x.shape
    for g, w in zip(got, want):
        _close(g, w)
    loss, out, grads, eps = _jax_train(jmod, params, jnp.asarray(x))
    got = tmod.train()(torch.from_numpy(x), eps=eps)
    t_loss, _ = vae_loss(got, torch.from_numpy(x), beta=0.5)
    t_loss.backward()
    assert abs(float(t_loss) - loss) <= 2e-5 * abs(loss)
    want_g = vae_state_dict_from_flax(tmod, grads)
    # conv biases an instance norm follows: 0 up to rounding on both sides
    normed = re.compile(rf"(down\d+|down\d+\.conv\d+|up[0-{tmod.n_up - 2}])\.bias")
    for k, p in tmod.named_parameters():
        if normed.fullmatch(k):
            scale = float(want_g[k[:-4] + "weight"].abs().max())
            assert float(p.grad.abs().max()) < 1e-3 * scale and float(want_g[k].abs().max()) < 1e-3 * scale, k
        elif p.numel() == 1:  # a PReLU slope, a one-channel output's bias: within 2e-3 of itself
            assert abs(float(p.grad) - float(want_g[k])) <= 2e-3 * abs(float(want_g[k])) + 1e-7, k
        else:
            try:
                _close(p.grad, want_g[k].numpy())
            except AssertionError as e:
                raise AssertionError(f"{k}: {e}") from None


def test_vae_loss_and_cosine_anneal_match_jax():
    out = [_x((2, 1, 4, 8, 8), 20), _x((2, 6), 21), _x((2, 6), 22), _x((2, 6), 23)]
    target = _x((2, 1, 4, 8, 8), 24)
    want, wm = j25.vae_loss(j25.VaeOutput(*map(jnp.asarray, out)), jnp.asarray(target), beta=0.3)
    got, gm = vae_loss(VaeOutput(*map(torch.from_numpy, out)), torch.from_numpy(target), beta=0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("loss/recon", "loss/kl"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)
    for args in ((0.0, 1.0, 3, 10), (0.5, 2.0, 0, 7), (1.0, 0.1, 7, 7), (0.2, 0.9, 12, 5), (0.0, 1.0, 1, 0)):
        assert tschedule.cosine_anneal(*args) == jschedule.cosine_anneal(*args)


# -- the engine ----------------------------------------------------------------------------------


def test_beta_vae_module_across_an_epoch_boundary():
    """Cosine beta over 3 warm-up epochs: epochs 0 and 1, each the JAX
    engine's beta and training loss (its latent noise handed in) and
    validation loss; ``source`` stands in for a missing ``anchor``."""
    cfg = dict(TRAIN, backbone="convnextv2_test")
    kw = dict(beta=2.0, beta_schedule="cosine", beta_start=0.1, beta_warmup_epochs=3)
    x = _x((2, 2, 8, 64, 64), 30)
    j = jengine.BetaVaeModule(vae=dict(cfg), **kw)
    params = flax_params(j.model, 31, jnp.asarray(x))
    t = tengine.BetaVaeModule(vae=dict(cfg), device="cpu", **kw)
    load_flax_params(t.model, params)
    assert t.current_beta == j.current_beta == 0.1
    jb = {"anchor": jnp.asarray(x)}
    sample = jax.jit(lambda p, a, k: j.model.apply({"params": p}, a, deterministic=False, rngs={"latent": k}))
    for epoch in (0, 1):
        j.on_epoch_start(epoch)
        t.on_epoch_start(epoch)
        assert t.current_beta == j.current_beta
        loss, _ = jax.jit(lambda p, b, k: j.training_loss({"params": p}, b, k))(params, jb, jax.random.PRNGKey(epoch))
        out = sample(params, jnp.asarray(x), jax.random.PRNGKey(epoch))
        eps = torch.from_numpy(((np.asarray(out.z) - np.asarray(out.mean))
                                * np.exp(-0.5 * np.asarray(out.logvar))).astype(np.float32))
        got = t.train().training_loss({"source": torch.from_numpy(x)}, eps=eps)
        np.testing.assert_allclose(float(got), float(loss), rtol=2e-5)
    want_v, _ = jax.jit(lambda p, b: j.validation_loss({"params": p}, b, None))(params, jb)
    with torch.no_grad():
        np.testing.assert_allclose(float(t.eval().validation_loss({"anchor": torch.from_numpy(x)})), float(want_v),
                                   rtol=2e-5)
        pred = t.predict_step({"anchor": torch.from_numpy(x)})
    want_p = jax.jit(lambda p, b: j.predict_step({"params": p}, b))(params, jb)
    for k in ("features", "projections"):
        _close(pred[k], want_p[k])


def test_the_trainer_anneals_beta_at_each_epoch_start():
    class DM:
        def setup(self, stage):
            pass

        def train_dataloader(self):
            return [{"anchor": _x((1, 2, 8, 64, 64), 40)}]

    t = tengine.BetaVaeModule(vae=dict(TRAIN, backbone="convnextv2_test"), beta=1.0, beta_schedule="cosine",
                              beta_warmup_epochs=4, device="cpu")
    seen = []
    t.on_epoch_start = (lambda f: lambda e: (f(e), seen.append(t.current_beta)))(t.on_epoch_start)
    Trainer(max_epochs=3, device="cpu", checkpoint_every_n_epochs=10, use_tensorboard=False).fit(t, DM())
    assert seen == [tschedule.cosine_anneal(0.0, 1.0, e, 4) for e in range(3)] and seen[0] == 0.0 < seen[2]


def test_the_reference_class_paths_resolve_to_the_port():
    assert resolve_class("dynaclr.vae_engine.BetaVaeModule") is tengine.BetaVaeModule
    assert resolve_class("viscy_models.vae.BetaVae25D") is BetaVae25D
    assert resolve_class("viscy_models.vae.beta_vae_monai.BetaVaeMonai") is BetaVaeConv
    assert resolve_class("viscy_tpu.models.vae.beta_vae_conv.BetaVaeConv") is BetaVaeConv


@pytest.mark.parametrize("which", ["25d", "conv"])
def test_bridge_carries_every_flax_leaf_bit_for_bit(which):
    """Every flax leaf lands in exactly one port tensor, bit for bit (its
    values, in the layout's order), and the port model takes the result
    with ``strict=True``."""
    if which == "25d":
        jmod, tmod = j25.BetaVae25D(backbone="convnext_test", **VAE), BetaVae25D(backbone="convnext_test", **VAE)
        x = _x((1, 2, 8, 64, 64), 50)
    else:
        cfg = CONV_CASES["3d-res"]
        jmod, tmod = jconv.BetaVaeConv(**cfg), BetaVaeConv(**cfg)
        x = _x((1, *cfg["in_shape"]), 50)
    params = flax_params(jmod, 51, jnp.asarray(x))
    state = state_dict_from_flax(tmod, params)
    tmod.load_state_dict(state, strict=True)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(state) == len(leaves) == len(tmod.state_dict())
    key = lambda a: np.sort(np.asarray(a, np.float32).ravel()).tobytes()
    assert sorted(map(key, leaves)) == sorted(key(t.numpy()) for t in state.values())


# -- end to end ----------------------------------------------------------------------------------


def _tracks(path: Path, rng) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["track_id", "t", "id", "parent_track_id", "parent_id", "z", "y", "x"])
        for tid in (1, 2, 3):
            y, x = rng.uniform(44, 52, 2)
            for t in range(2):
                w.writerow([tid, t, tid * 10 + t, -1, -1, 4, f"{y:.2f}", f"{x:.2f}"])


def test_vae_fit_and_predict_through_the_cli(tmp_path):
    """``configs/dynaclr_fit.yml``'s data node (a plate and its track CSVs)
    with the model replaced by a narrow ``BetaVaeModule`` (v2 backbone,
    (2, 8, 8) stem): ``fit``, then ``predict`` from ``last`` through the
    ``EmbeddingWriter``; the store's ``X`` is the VAE's mean and its
    projections z (= the mean in eval), bit for bit against
    ``predict_step`` on the store's own windows."""
    plate = build_hcs_plate(tmp_path / "plate.zarr", ["Phase3D", "RFP"], zyx_shape=(10, 96, 96), num_timepoints=2,
                            rows=("A",), cols=("1",), fovs=("0", "1"), seed=6)
    rng = np.random.default_rng(7)
    for name, pos in open_ome_zarr(plate, mode="r+").positions():
        pos.zattrs["normalization"] = {c: {"fov_statistics": {"mean": 0.5, "std": 0.3}} for c in ("Phase3D", "RFP")}
        _tracks(tmp_path / "tracks" / name / "tracks.csv", rng)
    model = {"class_path": "dynaclr.vae_engine.BetaVaeModule",
             "init_args": {"vae": {k: list(v) if isinstance(v, tuple) else v for k, v in
                                   dict(TRAIN, backbone="convnextv2_test").items()},
                           "beta": 0.5, "beta_schedule": "cosine", "beta_warmup_epochs": 2, "lr": 1e-3}}
    data = dict(data_path=str(plate), tracks_path=str(tmp_path / "tracks"), z_range=[1, 9],
                initial_yx_patch_size=[64, 64], final_yx_patch_size=[64, 64])

    def config(name: str, edit) -> str:
        cfg = load_composed_config(ROOT / "configs" / name)
        cfg["model"] = model
        cfg["data"]["init_args"].update(data)
        edit(cfg)
        (tmp_path / name).write_text(yaml.safe_dump(cfg))
        return str(tmp_path / name)

    root = tmp_path / "run"

    def fit_edit(cfg):
        cfg["data"]["init_args"].update(batch_size=2, num_workers=0)
        cfg["trainer"] = {"device": "cpu", "max_epochs": 2, "limit_train_batches": 1, "limit_val_batches": 1,
                          "default_root_dir": str(root), "log_every_n_steps": 1}

    trainer = cli.main(["fit", "-c", config("dynaclr_fit.yml", fit_edit)])
    assert trainer.global_step == 2 and np.isfinite(trainer.logged_metrics["loss/validate"])
    store = tmp_path / "emb.zarr"

    def pred_edit(cfg):
        cfg["data"]["init_args"].update(batch_size=4, num_workers=0, predict_cells=False)
        cfg["trainer"] = {"device": "cpu", "default_root_dir": str(tmp_path / "pred"), "callbacks": [
            {"class_path": "viscy_utils.callbacks.EmbeddingWriter", "init_args": {"output_path": str(store)}}]}
        cfg["ckpt_path"] = str(root / "checkpoints" / "last")

    trainer = cli.main(["predict", "-c", config("dynaclr_predict.yml", pred_edit)])
    got = tew.read_embedding_dataset(store)
    dm = trainer._active_datamodule
    module = tengine.BetaVaeModule(vae=dict(TRAIN, backbone="convnextv2_test"), device="cpu").eval()
    module.model.load_state_dict(read_checkpoint(root / "checkpoints" / "last")[1])
    feats = []
    with torch.inference_mode():
        for batch in dm.predict_dataloader():
            b = {k: (torch.from_numpy(v) if k == "anchor" else v) for k, v in batch.items()}
            b["anchor_norm_meta"] = {c: {lv: {s: torch.from_numpy(a) for s, a in st.items()}
                                         for lv, st in m.items()} for c, m in batch["anchor_norm_meta"].items()}
            feats.append(module.predict_step(dm.device_transform(b, None, "predict"))["features"].numpy())
    assert got.X.shape == (len(dm.predict_dataset), 16) and got.n_obs == 12
    np.testing.assert_array_equal(got.X, np.concatenate(feats))
    np.testing.assert_array_equal(got.obsm["X_projections"], got.X)
