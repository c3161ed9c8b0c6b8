"""DynaCLR's contrastive encoder, losses and train step in the port against
viscy_tpu.

Inputs, weights and BatchNorm running statistics are numpy-seeded and
reach the port through ``contrastive_state_dict_from_flax``; the JAX
references run under ``jax.jit``. The BatchNorm trap: flax updates the
running variance with the BIASED batch variance (torch's BatchNorm would
store the unbiased one), so every running statistic is compared after the
calls that update it. Tolerances (float32): outputs and gradients within
2e-3 of the range with Pearson r > 0.9999 (the repo's torch-parity bound);
running statistics, losses and parameters after AdamW as stated.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.apps.dynaclr import engine as jdyn
from viscy_tpu.models.components import heads as jheads
from viscy_tpu.models.components.blocks import CONVNEXT_ARCHS
from viscy_tpu.models.components import stems as jstems
from viscy_tpu.models.contrastive import loss as jloss
from viscy_tpu.models.contrastive.encoder import ContrastiveEncoder as JEncoder
from viscy_tpu.models.contrastive.resnet3d import ResNet3dEncoder as JResNet
from viscy_tpu.training import state_dict_inventory as inventory
from viscy_tpu.training.convert import _CONTRASTIVE_RULES, convert_state_dict_full
from viscy_tpu.training.trainer import Trainer as JTrainer
from viscy_tpu_torch.apps.dynaclr import engine as tdyn
from viscy_tpu_torch.models.components.heads import ProjectionMLP
from viscy_tpu_torch.models.components.stems import StemDepthtoChannels
from viscy_tpu_torch.models.contrastive import loss as tloss
from viscy_tpu_torch.models.contrastive.encoder import ContrastiveEncoder
from viscy_tpu_torch.models.contrastive.resnet3d import ResNet3dEncoder
from viscy_tpu_torch.training.compose import load_composed_config
from viscy_tpu_torch.training.convert import contrastive_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.training.instantiate import instantiate
from viscy_tpu_torch.training.trainer import Trainer

from _torch_port_helpers import assert_rel_close, seeded_params

ROOT = Path(__file__).resolve().parents[1]
# narrow stand-in for configs/dynaclr_fit.yml's encoder (dims 16-128; depth
# 10 so the stem's 2 slices fold into the first width, 16)
TINY = dict(backbone="convnext_test", in_channels=2, in_stack_depth=10, stem_kernel_size=(5, 4, 4),
            stem_stride=(5, 4, 4), embedding_dim=32, projection_dim=16)


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


def _variables(module, seed: int, *args, **kwargs) -> tuple[dict, dict]:
    """Seeded numpy ``params`` and ``batch_stats`` (means N(0, 0.1), variances
    U(0.5, 1.5)) for a flax module."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.normal(0, 0.1, s.shape) if path[-1].key == "mean" else rng.uniform(0.5, 1.5, s.shape))
        .astype(np.float32),
        shapes.get("batch_stats", {}),
    )
    return seeded_params(shapes["params"], seed), stats


def _jvars(params, stats):
    return {"params": jax.tree_util.tree_map(jnp.asarray, params),
            "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}


def _assert_stats(model: torch.nn.Module, stats: dict, bridge, atol=1e-6) -> None:
    want = bridge({}, jax.tree_util.tree_map(np.asarray, stats))
    state = model.state_dict()
    assert want and all(k.endswith(("running_mean", "running_var")) for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=atol, rtol=1e-5, err_msg=k)


# -- state dict, bridge, config ---------------------------------------------------------------


def test_state_dict_equals_released_inventory():
    model = tdyn.ContrastiveModule(encoder=dict(backbone="convnext_tiny", in_channels=2, in_stack_depth=15),
                                   device="cpu").model
    sd = model.state_dict()
    inv = inventory.released_inventory("dynaclr_contrastive")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v) for k, v in inv.items()}
    assert sd["projection.1.num_batches_tracked"].dtype == torch.long


@pytest.mark.parametrize("backbone", ["convnext_test", "convnextv2_test"])
def test_bridge_carries_params_and_batch_stats(backbone, monkeypatch):
    """Every parameter and running statistic lands under its reference name
    (the inventory's keys but ``num_batches_tracked``), and the JAX
    converter takes the port's state dict back to the same trees, bit for
    bit."""
    monkeypatch.setitem(inventory.BACKBONES, backbone, (*CONVNEXT_ARCHS[backbone], "v2" in backbone))
    cfg = dict(TINY, backbone=backbone)
    params, stats = _variables(JEncoder(**cfg), 3, jnp.zeros((1, 2, 10, 64, 64)))
    model = ContrastiveEncoder(**cfg)
    load_flax_params(model, params, stats)
    bridged = contrastive_state_dict_from_flax(params, stats)
    inv = inventory.contrastive_state_dict_inventory(
        **{k: cfg[k] for k in ("backbone", "in_channels", "in_stack_depth", "stem_kernel_size", "stem_stride",
                               "embedding_dim", "projection_dim")})
    assert set(inv) - set(bridged) == {"projection.1.num_batches_tracked", "projection.4.num_batches_tracked"}
    assert set(bridged) <= set(inv)
    back_params, back_stats, unmatched = convert_state_dict_full(
        {k: v.numpy() for k, v in model.state_dict().items()}, _CONTRASTIVE_RULES, "")
    assert not unmatched
    for orig, back in ((params, back_params), (stats, back_stats)):
        flat_o, flat_b = jax.tree_util.tree_leaves_with_path(orig), dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_o) == len(flat_b)
        for path, v in flat_o:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), v, err_msg=str(path))


def test_dynaclr_fit_config_model_instantiates_and_its_data_is_refused():
    cfg = load_composed_config(ROOT / "configs/dynaclr_fit.yml")
    node = dict(cfg["model"], init_args=dict(cfg["model"]["init_args"], device="cpu"))
    module = instantiate(node)
    assert isinstance(module, tdyn.ContrastiveModule) and isinstance(module.loss_function, tloss.NTXentLoss)
    assert module.loss_function.temperature == 0.07 and module.lr == 1e-3
    assert module.model.in_stack_depth == 15 and module.example_input()["anchor"].shape == (1, 2, 15, 256, 256)
    # the data node is ported now: it instantiates whole
    dm = instantiate(cfg["data"])
    assert type(dm).__name__ == "TripletDataModule" and dm.source_channel == ["Phase3D", "RFP"]
    assert dm.z_window_size == 15 and dm.batch_size == 32


def test_auxiliary_heads_are_refused_by_name():
    """Heads are ported; what neither package can run is refused by name: a
    head node without a class_path, and a head with BatchNorm (the engine
    keeps no head batch statistics)."""
    with pytest.raises(ValueError, match="auxiliary_heads.*infection.*class_path"):
        tdyn.ContrastiveModule(encoder=dict(TINY), auxiliary_heads={"infection": {}}, device="cpu")
    node = {"class_path": "viscy_tpu.models.components.heads.ClassificationHead",
            "init_args": {"in_dims": 128, "norm": "bn"}}
    with pytest.raises(NotImplementedError, match="norm='bn'"):
        tdyn.ContrastiveModule(encoder=dict(TINY), auxiliary_heads={"infection": node}, device="cpu")


# -- parts --------------------------------------------------------------------------------------


def test_stem_depth_to_channels_matches_jax_and_refuses_a_remainder():
    jmod = jstems.StemDepthtoChannels(2, 10, 16, (5, 4, 4), (5, 4, 4))
    x = _x((2, 2, 10, 32, 32), 4)
    params, _ = _variables(jmod, 5, jnp.asarray(x))
    want = jax.jit(lambda p, v: jmod.apply({"params": p}, v))(params, jnp.asarray(x))
    tmod = StemDepthtoChannels(2, 10, 16, torch.Generator().manual_seed(0))
    tmod.load_state_dict({k[len("stem."):]: v for k, v in contrastive_state_dict_from_flax({"stem": params}).items()})
    got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="needs to output 1 more channels"):
        StemDepthtoChannels(2, 15, 16, torch.Generator())


def test_projection_mlp_matches_flax_running_stats_included():
    """Two train-mode calls (batch statistics; the running variance updated
    with the biased variance, unlike torch's BatchNorm), then eval mode."""
    jmod = jheads.ProjectionMLP(in_dims=24, hidden_dims=32, out_dims=8)
    xs = [_x((6, 24), 6), _x((6, 24), 7) * 2 + 1]
    params, stats = _variables(jmod, 8, jnp.zeros((2, 24)))
    tmod = ProjectionMLP(24, 32, 8, torch.Generator().manual_seed(0))
    bridge = lambda p, s: {k[len("projection."):]: v for k, v in
                           contrastive_state_dict_from_flax({"projection": p}, {"projection": s}).items()}
    state = tmod.state_dict()
    state.update(bridge(params, stats))
    tmod.load_state_dict(state)
    apply = jax.jit(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))
    variables = _jvars(params, stats)
    tmod.train()
    for x in xs:
        want, upd = apply(variables, jnp.asarray(x))
        variables = {**variables, **upd}
        _close(tmod(torch.from_numpy(x)), want)
    for k, v in bridge({}, jax.tree_util.tree_map(np.asarray, variables["batch_stats"])).items():
        np.testing.assert_allclose(tmod.state_dict()[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-5, err_msg=k)
    assert int(tmod[1].num_batches_tracked) == 2
    # torch's own BatchNorm keeps the unbiased variance: a different running_var
    bn = torch.nn.BatchNorm1d(32, momentum=0.1)
    bn.load_state_dict({k[2:]: v for k, v in state.items() if k.startswith("1.")})
    with torch.no_grad():
        bn(torch.nn.functional.linear(torch.from_numpy(xs[0]), tmod[0].weight, tmod[0].bias))
    assert not torch.allclose(bn.running_var, tmod[1].running_var)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(xs[0]))
    _close(tmod.eval()(torch.from_numpy(xs[0])), want)


@pytest.mark.parametrize("backbone", ["convnext_test", "convnextv2_test"])
def test_encoder_matches_flax_in_both_modes(backbone):
    """Two train-mode calls with ``mutable=["batch_stats"]`` (the embedding,
    the projection and the running statistics after both), then eval mode
    on the updated statistics. v1 blocks run plain torch, v2 blocks the fused
    kernel's plain version."""
    cfg = dict(TINY, backbone=backbone)
    jmod = JEncoder(**cfg)
    xs = [_x((4, 2, 10, 64, 64), 9), _x((4, 2, 10, 64, 64), 10)]
    params, stats = _variables(jmod, 11, jnp.asarray(xs[0]))
    model = ContrastiveEncoder(**cfg)
    load_flax_params(model, params, stats)
    apply = jax.jit(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))
    variables = _jvars(params, stats)
    model.train()
    for x in xs:
        (emb, proj), upd = apply(variables, jnp.asarray(x))
        variables = {**variables, **upd}
        got_emb, got_proj = model(torch.from_numpy(x))
        assert got_emb.shape == (4, 128) and got_proj.shape == (4, 16)
        _close(got_emb, emb)
        _close(got_proj, proj)
    _assert_stats(model, variables["batch_stats"], contrastive_state_dict_from_flax)
    emb, proj = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(xs[0]))
    with torch.no_grad():
        got_emb, got_proj = model.eval()(torch.from_numpy(xs[0]))
    _close(got_emb, emb)
    _close(got_proj, proj)


def test_resnet3d_matches_flax_in_both_modes():
    from viscy_tpu_torch.training.convert import resnet3d_state_dict_from_flax

    cfg = dict(in_channels=2, base_channels=8, layers=(1, 2), embedding_dim=16, projection_dim=8)
    jmod = JResNet(**cfg)
    x = _x((3, 2, 3, 15, 16), 12)
    params, stats = _variables(jmod, 13, jnp.asarray(x))
    model = ResNet3dEncoder(**cfg)
    load_flax_params(model, params, stats)
    (emb, proj), upd = jax.jit(lambda v, a: jmod.apply(v, a, train=True, mutable=["batch_stats"]))(
        _jvars(params, stats), jnp.asarray(x))
    got_emb, got_proj = model.train()(torch.from_numpy(x))
    _close(got_emb, emb)
    _close(got_proj, proj)
    _assert_stats(model, upd["batch_stats"], resnet3d_state_dict_from_flax)
    emb, proj = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(_jvars(params, upd["batch_stats"]), jnp.asarray(x))
    with torch.no_grad():
        got_emb, got_proj = model.eval()(torch.from_numpy(x))
    _close(got_emb, emb)
    _close(got_proj, proj)


# -- losses --------------------------------------------------------------------------------------


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_ntxent_loss_and_gradients_match_jax(beta):
    z1, z2 = _x((8, 16), 14), _x((8, 16), 15)
    want, (g1, g2) = jax.value_and_grad(lambda a, b: jloss.ntxent_loss(a, b, 0.2, beta=beta), argnums=(0, 1))(
        jnp.asarray(z1), jnp.asarray(z2))
    t1, t2 = torch.from_numpy(z1).requires_grad_(), torch.from_numpy(z2).requires_grad_()
    got = tloss.ntxent_loss(t1, t2, 0.2, beta=beta)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close(t1.grad, g1)
    _close(t2.grad, g2)
    cls = tloss.NTXentHCL(0.2, beta=beta) if beta else tloss.NTXentLoss(0.2)
    np.testing.assert_allclose(float(cls(torch.from_numpy(z1), torch.from_numpy(z2))), float(want), rtol=1e-5)


def test_temperature_schedule_steps_as_jax():
    kw = dict(temperature=0.07, temperature_schedule="cosine", temperature_start=0.5, temperature_warmup_epochs=10)
    got, want = tloss.NTXentLoss(**kw), jloss.NTXentLoss(**kw)
    for epoch in (0, 3, 9, 10, 25):
        got.step(epoch)
        want.step(epoch)
        np.testing.assert_allclose(got.temperature, want.temperature, rtol=1e-12)
    const = tloss.NTXentLoss(0.07)
    const.step(5)
    assert const.temperature == 0.07


def test_triplet_loss_and_gradients_match_jax():
    a, p, n = _x((8, 16), 16), _x((8, 16), 17), _x((8, 16), 18) * 0.5
    want, grads = jax.value_and_grad(lambda *v: jloss.triplet_margin_loss(*v, margin=1.0), argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(n))
    ts = [torch.from_numpy(v).requires_grad_() for v in (a, p, n)]
    got = tdyn.TripletMarginLoss(1.0)(*ts)
    got.backward()
    assert 0 < float(got.detach())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for t, g in zip(ts, grads):
        _close(t.grad, g)


# -- the engine ----------------------------------------------------------------------------------


def _batch(n, seed):
    return {k: np.random.default_rng(seed + i).random((n, 2, 10, 64, 64), np.float32)
            for i, k in enumerate(("anchor", "positive", "negative"))}


@pytest.fixture(scope="module")
def variables():
    return _variables(JEncoder(**TINY), 19, jnp.zeros((1, 2, 10, 64, 64)))


@pytest.mark.parametrize("loss", ["ntxent", "triplet"])
def test_training_and_validation_loss_match_jax(variables, loss):
    """``training_loss``: anchor, positive (and, for the triplet loss,
    negative) forwarded one after the other, each with its own batch
    statistics and running-statistic update; the loss, every gradient and
    the running statistics after it. ``validation_loss`` on the running
    statistics."""
    params, stats = variables
    make = lambda m: m.NTXentLoss(0.5) if loss == "ntxent" else m.TripletMarginLoss(0.5)
    jmod = jdyn.ContrastiveModule(encoder=dict(TINY), loss_function=make(jloss if loss == "ntxent" else jdyn))
    batch = _batch(4, 20)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        value, (_, extra) = jmod.training_loss({"params": p, "batch_stats": _jvars(params, stats)["batch_stats"]},
                                               jb, jax.random.PRNGKey(0))
        return value, extra

    (want, extra), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(_jvars(params, stats)["params"])
    want_val = jax.jit(lambda v: jmod.validation_loss(v, jb, jax.random.PRNGKey(0))[0])(_jvars(params, stats))
    tmod = tdyn.ContrastiveModule(encoder=dict(TINY), loss_function=make(tloss if loss == "ntxent" else tdyn),
                                  device="cpu")
    load_flax_params(tmod.model, params, stats)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got_val = tmod.eval().validation_loss(tb)
    np.testing.assert_allclose(float(got_val), float(want_val), rtol=1e-5)
    got = tmod.train().training_loss(tb, torch.Generator())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _assert_stats(tmod.model, extra["batch_stats"], contrastive_state_dict_from_flax)
    views = 2 if loss == "ntxent" else 3
    assert int(tmod.model.projection[1].num_batches_tracked) == views
    want_g = contrastive_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {name: p.grad for name, p in tmod.model.named_parameters()}
    # shifts the loss cannot see have a gradient of 0 up to rounding on both sides: the next
    # train-mode BatchNorm removes them, and the triplet loss's differences the last one
    shifts = SHIFTS | ({"projection.4.bias"} if loss == "triplet" else set())
    for name, g in grads.items():
        if name in shifts:
            scale = np.abs(grads[name.replace("bias", "weight")].numpy()).max()
            assert np.abs(g.numpy()).max() < 1e-5 * scale and np.abs(want_g[name].numpy()).max() < 1e-5 * scale
        else:
            assert_rel_close(g.numpy(), want_g[name].numpy(), 2e-3, 0.9999)


# parameters whose gradient is 0 up to rounding: a shift the next train-mode BatchNorm removes
SHIFTS = {"encoder.head.norm.bias", "projection.0.bias", "projection.3.bias"}


class _Data:
    def __init__(self, train, val):
        self.train, self.val = train, val

    def prepare_data(self):
        pass

    def setup(self, stage):
        pass

    def train_dataloader(self):
        return list(self.train)

    def val_dataloader(self):
        return list(self.val)


def _without_shifts(configure):
    """``configure_optimizers`` with the :data:`SHIFTS` biases left out of
    the update, as ``freeze_backbone`` leaves parameters out (optax
    ``set_to_zero`` on the JAX side, not in the optimizer on the port's)."""

    def jax_side(total_steps):
        import optax

        tx, sched = configure(total_steps)
        shifted = {"head_norm/bias", "projection/fc0/bias", "projection/fc1/bias"}
        label = lambda tree: jax.tree_util.tree_map_with_path(
            lambda path, _: "frozen" if "/".join(p.key for p in path) in shifted else "trained", tree)
        return optax.multi_transform({"trained": tx, "frozen": optax.set_to_zero()}, label), sched

    return jax_side


def test_two_fit_steps_match_two_jax_steps(variables, tmp_path):
    """Two ``Trainer.fit`` steps and one validation batch against the JAX
    ``Trainer``'s (NT-Xent, AdamW at a constant 1e-3): both steps' losses,
    the validation loss, every parameter and running statistic after the
    steps; then ``predict_step`` (eval mode).

    AdamW turns a gradient at rounding level into a step of about ``lr`` of
    either sign, in JAX and in torch alike. The three biases whose gradient
    is 0 up to rounding (:data:`SHIFTS`) are therefore left out of both
    optimizers; of the other parameters' elements, the few whose gradient is
    at rounding level are held to Adam's bound (|d| <= 2 steps x 2 lr), all
    others (at least 99.9 % of the elements) to 1e-5."""
    params, stats = variables
    train = [{k: v for k, v in _batch(4, 30 + 3 * i).items() if k != "negative"} for i in range(2)]
    val = [{k: v for k, v in _batch(4, 40).items() if k != "negative"}]
    jmod = jdyn.ContrastiveModule(encoder=dict(TINY), loss_function=jloss.NTXentLoss(0.5), lr=1e-3)
    jmod.init_variables = lambda rng, batch: _jvars(params, stats)
    jmod.configure_optimizers = _without_shifts(jmod.configure_optimizers)
    jtrainer = JTrainer(max_steps=2, default_root_dir=tmp_path / "j", use_tensorboard=False, seed=0,
                        log_every_n_steps=1, checkpoint_every_n_epochs=10**6)
    jtrainer.fit(jmod, _Data(train, val))
    tmod = tdyn.ContrastiveModule(encoder=dict(TINY), loss_function=tloss.NTXentLoss(0.5), lr=1e-3, device="cpu")
    load_flax_params(tmod.model, params, stats)
    for name in SHIFTS:
        tmod.model.get_parameter(name).requires_grad_(False)
    trainer = Trainer(max_steps=2, default_root_dir=tmp_path / "t", seed=0, log_every_n_steps=1,
                      checkpoint_every_n_epochs=10**6, device="cpu")
    trainer.fit(tmod, _Data(train, val))

    def losses(root):
        lines = [json.loads(line) for line in (root / "metrics.csv").read_text().splitlines()]
        return [line[k] for line in lines for k in ("loss/train", "loss/validate") if k in line]

    np.testing.assert_allclose(losses(tmp_path / "t"), losses(tmp_path / "j"), rtol=1e-5)
    jparams = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
    jstats = jax.tree_util.tree_map(np.asarray, jtrainer.state.extra_vars["batch_stats"])
    _assert_stats(tmod.model, jstats, contrastive_state_dict_from_flax)
    state, before = tmod.model.state_dict(), contrastive_state_dict_from_flax(params)
    off = total = 0
    for name, w in contrastive_state_dict_from_flax(jparams).items():
        d = (state[name] - w).abs()
        assert float(d.max()) <= 2 * 2 * 1e-3, name
        assert torch.equal(state[name], before[name]) == (name in SHIFTS), name
        off, total = off + int((d > 1e-5).sum()), total + d.numel()
    assert off <= 1e-3 * total, (off, total)
    jvars = {"params": jtrainer.state.params, **jtrainer.state.extra_vars}
    jpred = jax.jit(lambda v, x: jmod.predict_step(v, {"anchor": x}))(jvars, jnp.asarray(val[0]["anchor"]))
    with torch.no_grad():
        pred = tmod.eval().predict_step({"anchor": torch.from_numpy(val[0]["anchor"])})
    assert set(pred) == {"features", "projections"}
    for k in pred:
        _close(pred[k], jpred[k])


def test_views_draw_the_same_drop_path_masks():
    """With stochastic depth, every view of a step draws the same keep masks
    (JAX hands each forward the step's one dropout key), and the generator
    ends where one view's draws leave it."""
    tmod = tdyn.ContrastiveModule(encoder=dict(TINY, drop_path_rate=0.5), loss_function=tloss.NTXentLoss(0.5),
                                  device="cpu").train()
    x = torch.from_numpy(_batch(4, 50)["anchor"])
    batch = {"anchor": x, "positive": x.clone()}
    with torch.no_grad():
        a, p, n = tmod._views(batch, g := torch.Generator().manual_seed(0))
        other, _, _ = tmod._views(batch, torch.Generator().manual_seed(1))
        tmod.model(x, one := torch.Generator().manual_seed(0))
    assert n is None and torch.equal(a, p) and not torch.equal(a, other)
    assert torch.equal(g.get_state(), one.get_state())


def test_freeze_backbone_leaves_stem_and_encoder_out_of_the_optimizer():
    tmod = tdyn.ContrastiveModule(encoder=dict(TINY), freeze_backbone=True, device="cpu")
    opt = tmod.configure_optimizers(10)[0]
    trained = {id(p) for group in opt.param_groups for p in group["params"]}
    names = {n for n, p in tmod.model.named_parameters() if id(p) in trained}
    assert names and all(n.startswith("projection.") for n in names)
