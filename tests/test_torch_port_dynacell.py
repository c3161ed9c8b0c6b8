"""The dynacell engines (CELLDiff flow matching, ``DynacellUNet``) in the
port against viscy_tpu, the flax -> torch bridges of the 3-D U-Net family,
``configs/celldiff_fit.yml`` in the port, and a tiny ``viscy-torch fit``
then ``predict`` of it on the CPU.

Weights are numpy-seeded (the adaLN-Zero weights drawn away from zero) and
reach the port through its bridges; the training draws (``t`` and ``x0``)
and the predict noise are the JAX engine's, handed to the port. The JAX
references run under ``jax.jit``. Tolerances (float32): the loss within
1e-5 relative; every gradient and the sampled prediction within 2e-3 of
the range with Pearson r > 0.9999 (the repo's torch-parity bound; the
output conv's single bias within 2e-3 of itself); the
conv biases a following instance-wise group norm removes (one channel a
group) have a gradient of 0 up to rounding on both sides, below 1e-3 of
their kernel's; the bridges and the prediction store bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from viscy_tpu.apps.cytoland import engine as jcyto
from viscy_tpu.apps.dynacell import engine as jdyn
from viscy_tpu.data.hcs import HCSDataModule as JHCSDataModule
from viscy_tpu.models.celldiff import celldiff_net as jnet
from viscy_tpu.models.unet import unet3d as junet3d
from viscy_tpu.training.convert import convert_celldiff_state_dict, convert_unet3d_state_dict
from viscy_tpu_torch.apps.dynacell import engine as tdyn
from viscy_tpu_torch.data.hcs import HCSDataModule
from viscy_tpu_torch.models.celldiff import CELLDiffNet, UNetViT3D
from viscy_tpu_torch.models.unet.unet3d import Unet3d
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training.callbacks.prediction_writer import blend_in
from viscy_tpu_torch.training.compose import load_composed_config
from viscy_tpu_torch.training.convert import (
    celldiff_state_dict_from_flax,
    load_flax_params,
    state_dict_from_flax,
)
from viscy_tpu_torch.training.instantiate import instantiate, resolve_class
from viscy_tpu_torch.training.trainer import Trainer
from viscy_tpu_torch.zarr_io.store import open_ome_zarr
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

from _torch_port_helpers import assert_rel_close, flax_params

ROOT = Path(__file__).resolve().parents[1]
# narrow stand-in for configs/celldiff_fit.yml's net_config
NET = dict(in_channels=1, out_channels=1, cond_channels=1, dims=(8, 16, 16), num_res_block=(1, 2), hidden_size=32,
           num_heads=2, num_hidden_layers=2, patch_size=2, dim_head=16)
SHAPE = (2, 1, 4, 16, 16)


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _batch(seed=0) -> dict:
    return {"source": _x(SHAPE, seed), "target": _x(SHAPE, seed + 1)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _engines(seed: int = 30):
    jmod = jdyn.DynacellFlowMatching(model_config=dict(NET), num_sampling_steps=3)
    b = _batch()
    params = flax_params(jmod.model, seed, jnp.asarray(b["target"]), jnp.asarray(b["source"]), jnp.zeros(2))
    tmod = tdyn.DynacellFlowMatching(model_config=dict(NET), num_sampling_steps=3, device="cpu")
    load_flax_params(tmod.model, params)
    return jmod, tmod, params


# -- the flow-matching engine ----------------------------------------------------------------------


def test_flow_matching_loss_and_every_gradient_match_jax():
    """``training_loss`` at the (t, x0) the JAX engine draws from its key:
    the loss, then every parameter gradient against ``jax.grad``."""
    jmod, tmod, params = _engines()
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    rng = jax.random.PRNGKey(31)
    loss_fn = lambda p: jmod.training_loss({"params": p}, jb, rng)[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree_util.tree_map(jnp.asarray, params))
    jt, jx0, _ = jmod.transport.sample(rng, jb["target"])
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = tmod.training_loss(tb, t=torch.from_numpy(np.array(jt)), x0=torch.from_numpy(np.array(jx0)))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = celldiff_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), NET["patch_size"])
    got = {k: p.grad for k, p in tmod.model.named_parameters()}
    assert set(got) == set(want)
    # a conv bias before a one-channel-a-group norm (the 8-wide level) is removed by it
    removed = {k for k in got if k.endswith("proj.bias") and got[k].shape[0] == 8}
    assert len(removed) == 2 * (1 + 1)  # block1 and block2 of the encoder and decoder blocks at level 0
    for k, g in got.items():
        if k in removed:
            scale = float(want[k.replace("bias", "weight")].abs().max())
            assert float(g.abs().max()) < 1e-3 * scale and float(want[k].abs().max()) < 1e-3 * scale, k
        elif g.numel() == 1:  # outconv's one bias: relative to itself
            assert abs(float(g - want[k])) <= 2e-3 * abs(float(want[k])), k
        else:
            assert_rel_close(g.numpy(), want[k].numpy(), 2e-3, 0.9999)
    # validation draws from the generator it is given
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        a = tmod.validation_loss(tb, g)
        assert float(a) != float(tmod.validation_loss(tb, torch.Generator().manual_seed(6)))


def test_predict_step_matches_jax_from_its_noise():
    """Three Euler steps from the JAX engine's ``PRNGKey(0)`` noise; the
    port's default noise is the same on every call (a generator seeded with
    0 each time)."""
    jmod, tmod, params = _engines(32)
    b = _batch(2)
    want = jax.jit(lambda p, s: jmod.predict_step({"params": p}, {"source": s}))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(b["source"]))
    x0 = jax.random.normal(jax.random.PRNGKey(0), SHAPE, jnp.float32)
    with torch.no_grad():
        got = tmod.predict_step({"source": torch.from_numpy(b["source"])}, x0=torch.from_numpy(np.array(x0)))
        assert_rel_close(got.numpy(), np.asarray(want), 2e-3, 0.9999)
        once = tmod.predict_step({"source": torch.from_numpy(b["source"])})
        assert torch.equal(once, tmod.predict_step({"source": torch.from_numpy(b["source"])}))
    heun = tdyn.DynacellFlowMatching(model_config=dict(NET), sampler="heun", num_generate_steps=2, device="cpu")
    assert heun.num_sampling_steps == 2
    with torch.no_grad():
        assert heun.predict_step({"source": torch.from_numpy(b["source"])}).shape == SHAPE
    with pytest.raises(ValueError, match="sampler"):
        tdyn.DynacellFlowMatching(model_config=dict(NET), sampler="rk4", device="cpu")


@pytest.mark.parametrize("architecture", ["FNet3D", "UNetViT3D"])
def test_supervised_engines_match_jax(architecture):
    """``VSUNet("FNet3D")`` and ``DynacellUNet("UNetViT3D")``: the predict
    step (divisible pad, forward, crop) and the loss of a train-mode
    forward (L1 + L2) against the JAX engines on the same weights."""
    from viscy_tpu.training.losses.mixed_loss import MixedLoss as JMixedLoss
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss

    if architecture == "FNet3D":
        cfg = dict(depth=2, mult_chan=8, in_stack_depth=4)
        jeng = jcyto.VSUNet("FNet3D", dict(cfg), loss_function=JMixedLoss(0.5, 0.5, 0.0))
        teng = VSUNet("FNet3D", dict(cfg), loss_function=MixedLoss(0.5, 0.5, 0.0), device="cpu")
    else:
        cfg = {k: v for k, v in NET.items() if k != "cond_channels"}
        jeng = jdyn.DynacellUNet("UNetViT3D", dict(cfg), loss_function=JMixedLoss(0.5, 0.5, 0.0))
        teng = tdyn.DynacellUNet("UNetViT3D", dict(cfg), loss_function=MixedLoss(0.5, 0.5, 0.0), device="cpu")
    b = _batch(4)
    variables = jax.eval_shape(jeng.model.init, jax.random.PRNGKey(0), jnp.asarray(b["source"]))
    params = flax_params(jeng.model, 33, jnp.asarray(b["source"]))
    rng = np.random.default_rng(36)
    stats = jax.tree_util.tree_map(lambda s: rng.uniform(0.0, 0.5, s.shape).astype(np.float32),
                                   variables.get("batch_stats", {}))
    load_flax_params(teng.model, params, stats or None)
    jvars = {"params": params, **({"batch_stats": stats} if stats else {})}
    src = _x((1, 1, 4, 14, 30), 5)  # YX padded to 16 x 32 and cropped back
    want = jax.jit(lambda v, s: jeng.predict_step(v, {"source": s}))(jvars, jnp.asarray(src))
    teng.eval()
    with torch.no_grad():
        got = teng.predict_step({"source": torch.from_numpy(src)})
    assert got.shape == (1, 1, 4, 14, 30)
    assert_rel_close(got.numpy(), np.asarray(want), 2e-3, 0.9999)
    # (a train-mode forward moves FNet3D's running statistics: after the predict step)
    jloss = jax.jit(lambda v, bb: jeng.training_loss(v, bb, jax.random.PRNGKey(1))[0])(
        jvars, {k: jnp.asarray(v) for k, v in b.items()})
    teng.train()
    loss = teng.training_loss({k: torch.from_numpy(v) for k, v in b.items()}).detach()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))


# -- bridges ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["CELLDiffNet", "UNetViT3D", "FNet3D"])
def test_bridges_round_trip_bit_for_bit(net):
    """flax -> port (strict) -> the JAX package's converter -> flax: every
    leaf back bit for bit, FNet3D's batch statistics included."""
    x = jnp.zeros(SHAPE)
    if net == "FNet3D":
        cfg = dict(depth=2, mult_chan=8)
        jmod, tmod = junet3d.Unet3d(**cfg), Unet3d(**cfg)
        params = flax_params(jmod, 34, x)
        rng = np.random.default_rng(35)
        stats = jax.tree_util.tree_map(lambda s: rng.random(s.shape).astype(np.float32),
                                       jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["batch_stats"])
        load_flax_params(tmod, params, stats)
        back, back_stats = convert_unet3d_state_dict({k: v.numpy() for k, v in tmod.state_dict().items()})
        assert _flat(back_stats).keys() == _flat(stats).keys()
        for k, v in _flat(stats).items():
            np.testing.assert_array_equal(_flat(back_stats)[k], v, err_msg=k)
    else:
        cfg = dict(NET) if net == "CELLDiffNet" else {k: v for k, v in NET.items() if k != "cond_channels"}
        jmod = getattr(jnet, net)(**cfg)
        tmod = (CELLDiffNet if net == "CELLDiffNet" else UNetViT3D)(**cfg)
        args = (x, x, jnp.zeros(2)) if net == "CELLDiffNet" else (x,)
        params = flax_params(jmod, 34, *args)
        load_flax_params(tmod, params)
        state = {k: v.numpy() for k, v in tmod.state_dict().items()}
        # a reference checkpoint's fixed buffers load and are dropped
        tmod.load_state_dict({**tmod.state_dict(), "bottleneck.img_pos_embed": torch.zeros(1, 8, 32)})
        back, _ = convert_celldiff_state_dict(state)
    orig, got = _flat(params), _flat(back)
    assert got.keys() == orig.keys()
    for k, v in orig.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_state_dict_from_flax_names_a_type_it_cannot_map():
    with pytest.raises(TypeError, match="no flax -> torch bridge for a Linear"):
        state_dict_from_flax(torch.nn.Linear(2, 2), {})
    with pytest.raises(ValueError, match="CELLDiffNet has no batch statistics"):
        state_dict_from_flax(CELLDiffNet(**NET), {}, {"unet": {}})


# -- the shipped config ----------------------------------------------------------------------------


def test_shipped_config_instantiates_in_the_port():
    """``configs/celldiff_fit.yml`` as shipped: the model at its full width
    (its state names those of the JAX converter's rules), the datamodule,
    the trainer's callbacks."""
    cfg = load_composed_config(ROOT / "configs/celldiff_fit.yml")
    assert resolve_class(cfg["model"]["class_path"]) is tdyn.DynacellFlowMatching
    node = cfg["model"]
    module = instantiate(dict(node, init_args=dict(node["init_args"], device="cpu")))
    net = module.model
    assert isinstance(net, CELLDiffNet)
    assert net.dims == (64, 128, 256, 256) and net.num_res_block == (2, 2, 2)
    assert len(net.bottleneck.blocks) == 8 and net.bottleneck.patch_size == 4
    assert tuple(net._time_embedder.mlp[0].weight.shape) == (512, 256)
    assert tuple(net.bottleneck.blocks[0].attn.to_q.weight.shape) == (512, 512)
    assert module.transport.prediction == "velocity" and module.transport.path_type == "linear"
    assert (module.lr, module.schedule, module.num_sampling_steps) == (2e-4, "WarmupCosine", 50)
    params, stats = convert_celldiff_state_dict({k: v.numpy() for k, v in net.state_dict().items()})
    assert not stats and len(_flat(params)) == len(net.state_dict())
    dm = instantiate(cfg["data"])
    assert isinstance(dm, HCSDataModule)
    assert (dm.source_channel, dm.target_channel, dm.z_window_size, dm.yx_patch_size, dm.batch_size) == \
        (["Phase3D"], ["Fluor"], 8, (512, 512), 4)
    trainer = cli.build_trainer(dict(cfg["trainer"], device="cpu", default_root_dir="unused"))
    assert [type(c).__name__ for c in trainer.callbacks] == ["LearningRateMonitor", "ModelCheckpoint"]


def test_a_window_that_is_not_the_patch_is_refused_as_in_jax():
    """The shipped config has no crop: a training window other than
    (z_window_size, *yx_patch_size) raises in the JAX datamodule and in the
    port's, with the same message; the patch itself passes."""
    kw = dict(data_path=None, source_channel="Phase3D", target_channel=["Fluor"], z_window_size=8,
              yx_patch_size=(512, 512), num_workers=0)
    jdm, tdm = JHCSDataModule(**kw), HCSDataModule(**kw)
    for shape, ok in (((1, 1, 8, 1024, 1024), False), ((1, 1, 8, 512, 512), True)):
        x = np.zeros(shape, np.float32)
        jb = {"source": jnp.asarray(x), "target": jnp.asarray(x)}
        tb = {"source": torch.from_numpy(x), "target": torch.from_numpy(x)}
        if ok:
            jdm.device_transform(jb, jax.random.PRNGKey(0), "train")
            tdm.device_transform(tb, None, "train")
            continue
        msg = r"Source spatial shape \(8, 1024, 1024\) does not match expected \(8, 512, 512\)"
        with pytest.raises(ValueError, match=msg):
            jdm.device_transform(jb, jax.random.PRNGKey(0), "train")
        with pytest.raises(ValueError, match=msg):
            tdm.device_transform(tb, None, "train")


def test_celldiff_fit_and_predict_through_the_cli(tmp_path):
    """``fit -c`` the shipped config (a narrowed ``net_config``, windows 2
    deep, the paths, one step, the CPU) on a seeded plate of 512^2 FOVs,
    then ``predict``
    from ``last`` with ``HCSPredictionWriter`` (as ``viscy predict`` runs
    this engine; one Euler step, one FOV): the store equals ``predict_step``
    on the same window, blended, bit for bit."""
    plate = build_hcs_plate(tmp_path / "plate.zarr", ["Phase3D", "Fluor"], zyx_shape=(2, 512, 512),
                            num_timepoints=1, rows=("A",), cols=("1",), fovs=("0", "1"), norm_meta=True)
    net = dict(input_spatial_size=[2, 512, 512], in_channels=1, dims=[8, 8, 8, 8], num_res_block=[1, 1, 1],
               hidden_size=16, num_heads=1, dim_head=16, num_hidden_layers=1, patch_size=2)
    root = tmp_path / "root"
    fit = {"base": [str(ROOT / "configs/celldiff_fit.yml")],
           "model": {"init_args": {"net_config": net, "num_generate_steps": 1}},
           "data": {"init_args": {"data_path": str(plate), "z_window_size": 2, "batch_size": 1, "num_workers": 0}},
           "trainer": {"device": "cpu", "default_root_dir": str(root), "max_epochs": 1, "log_every_n_steps": 1}}
    (tmp_path / "fit.yml").write_text(yaml.safe_dump(fit))
    trainer = cli.main(["fit", "-c", str(tmp_path / "fit.yml")])
    assert trainer.global_step == 1 and np.isfinite(trainer.logged_metrics["loss/validate"])
    ckpt = root / "checkpoints" / "last"
    pred = {"model": fit["model"], "base": fit["base"],
            "data": {"init_args": {"data_path": str(plate), "z_window_size": 2, "num_workers": 0,
                                   "include_fov_names": ["A/1/1"]}},
            "trainer": {"device": "cpu", "default_root_dir": str(tmp_path / "p"), "callbacks": [
                {"class_path": "viscy_utils.callbacks.HCSPredictionWriter",
                 "init_args": {"output_store": str(tmp_path / "pred.zarr")}}]}}
    (tmp_path / "predict.yml").write_text(yaml.safe_dump(pred))
    cli.main(["predict", "-c", str(tmp_path / "predict.yml"), "--ckpt_path", str(ckpt)])
    cfg = load_composed_config(tmp_path / "predict.yml")
    module = instantiate(dict(cfg["model"], init_args=dict(cfg["model"]["init_args"], device="cpu")))
    Trainer(device="cpu", default_root_dir=tmp_path / "r").load_checkpoint(ckpt, module)
    module.eval()
    dm = instantiate(cfg["data"])
    dm.setup("predict")
    want = np.zeros((1, 2, 512, 512), np.float32)
    with torch.no_grad():
        for batch in dm.predict_dataloader():
            pred = module.predict_step({"source": torch.from_numpy(batch["source"])}).numpy()
            for i, (name, _, z) in enumerate(batch["index"]):
                assert name.strip("/") == "A/1/1/0" and z == 0  # the one window of the FOV
                want = blend_in(want, pred[i], slice(0, 2))
    store = open_ome_zarr(tmp_path / "pred.zarr")
    assert [name for name, _ in store.positions()] == ["A/1/1"]
    got = store["A/1/1"]["0"][0]
    assert store["A/1/1"].channel_names == ["Fluor"] and got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
