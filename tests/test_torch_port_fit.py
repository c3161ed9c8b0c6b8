"""The port's fit recipe (Trainer validation, checkpoints and resume, the CSV
logger, hooks, gradient clipping and accumulation, freeze_encoder; the
fg_mask route with SpotlightLoss) against viscy_tpu.

The tiny FCMAE-UNeXt2 of tests/test_torch_port_train.py (blocks (1, 1, 2,
1), dims 16-128, depth 5, 1 -> 2 channels; the port fused, the JAX side
unfused) with seeded JAX weights carried across by the weight bridge, on
numpy-seeded batches with no random transforms, TF32 off. The JAX side runs
its own ``Trainer`` with those weights in its state. Tolerances, float32:
losses to 1e-5 relative (SpotlightLoss alone to 1e-6); every gradient to
2e-3 of its range with Pearson r > 0.9999 (the torch-parity bound);
parameters after the steps to 1e-5 absolute (1 % of lr = 1e-3, see
test_torch_port_train.py); frozen parameters, checkpoint round trips and
resumed state bit for bit.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training import convert as jconvert
from viscy_tpu.training.callbacks.base import Callback as JCallback
from viscy_tpu.training.losses.mixed_loss import MixedLoss as JMixedLoss
from viscy_tpu.training.losses.spotlight import SpotlightLoss as JSpotlightLoss
from viscy_tpu.training.losses.spotlight import otsu_threshold_batch as j_otsu
from viscy_tpu.training.trainer import Trainer as JTrainer
from viscy_tpu_torch import transforms as T
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.data.gpu_aug import DeviceTransformDataModule
from viscy_tpu_torch.training.callbacks.base import Callback
from viscy_tpu_torch.training.callbacks.checkpoint import LearningRateMonitor, ModelCheckpoint
from viscy_tpu_torch.training.convert import fcmae_state_dict_from_flax, load_flax_params
from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss
from viscy_tpu_torch.training.losses.spotlight import SpotlightLoss, otsu_threshold_batch
from viscy_tpu_torch.training.optimizers import clip_by_global_norm_, configure_adamw_scheduler
from viscy_tpu_torch.training.trainer import CSVLogger, Trainer

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
NEVER = 10**6  # checkpoint_every_n_epochs that never saves


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _batch(seed, n=2, mask=False):
    rng = np.random.default_rng(seed)
    out = {
        "source": rng.random((n, 1, 5, 64, 64), np.float32),
        "target": rng.random((n, 2, 5, 64, 64), np.float32),
    }
    if mask:
        out["fg_mask"] = rng.random((n, 2, 5, 64, 64)) > 0.7
    return out


@pytest.fixture(scope="module")
def params():
    return flax_params(JFCMAE(**TINY), 31, jnp.zeros((1, 1, 5, 64, 64)))


class _Data:
    """Datamodule of fixed numpy batches for either package's trainer."""

    def __init__(self, train, val=None):
        self.train, self.val = train, val

    def prepare_data(self):
        pass

    def setup(self, stage):
        pass

    def train_dataloader(self):
        return list(self.train)

    def val_dataloader(self):
        return None if self.val is None else list(self.val)


def _jax_engine(params, loss=None, **kw):
    jmod = jengine.VSUNet("fcmae", dict(TINY, fused_mlp=False), loss_function=loss or JMixedLoss(0.5, 0.0, 0.5),
                          **ENGINE, **kw)
    jmod.init_variables = lambda rng, batch: {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    return jmod


def _torch_engine(params, loss=None, **kw):
    tmod = tengine.VSUNet("fcmae", dict(TINY, fused_mlp=True), loss_function=loss or MixedLoss(0.5, 0.0, 0.5),
                          device="cpu", **ENGINE, **kw)
    load_flax_params(tmod.model, params)
    return tmod


def jax_fit(params, root, train, val=None, engine_kw=None, callbacks=(), **trainer_kw):
    jmod = _jax_engine(params, **(engine_kw or {}))
    trainer = JTrainer(default_root_dir=root, use_tensorboard=False, seed=0, checkpoint_every_n_epochs=NEVER,
                       callbacks=list(callbacks), **trainer_kw)
    trainer.fit(jmod, _Data(train, val))
    return trainer


def port_fit(params, root, train, val=None, engine_kw=None, callbacks=(), **trainer_kw):
    tmod = _torch_engine(params, **(engine_kw or {}))
    trainer_kw.setdefault("checkpoint_every_n_epochs", NEVER)
    trainer = Trainer(default_root_dir=root, seed=0, callbacks=list(callbacks), device="cpu", **trainer_kw)
    trainer.fit(tmod, _Data(train, val))
    return trainer, tmod


def _assert_params_match(jtrainer, tmod, frozen_unchanged_from=None):
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    for name, p in tmod.model.named_parameters():
        if name in UNBRIDGED:
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
        if frozen_unchanged_from is not None and name.startswith("encoder."):
            assert torch.equal(p.detach(), frozen_unchanged_from[name]), name


# -- SpotlightLoss and the fg_mask route --------------------------------------------


def _pred_target(seed, shape=(2, 2, 5, 16, 16)):
    rng = np.random.default_rng(seed)
    return rng.normal(0.3, 0.5, shape).astype(np.float32), rng.random(shape).astype(np.float32)


def _bimodal(shape, seed):
    """A fluorescence-like target: 70 % background near 0.15, 30 %
    foreground near 0.7, each (sample, channel) spanning exactly [0, 1].

    Otsu's last bin (an empty upper class) divides the rounding error of
    ``cumsum[-1] - sum`` by 1e-10 in both packages (viscy_tpu
    ``losses/spotlight.py:_otsu_1d``), so where those sums round, the pick
    follows the summation order, which XLA and torch do not share. With a
    [0, 1] span the bin centers are dyadic and every sum is exact, so the
    two packages compare what the formula computes. (That formula puts
    this target's threshold near 0.045, where ``preprocess/stats.py``'s
    skimage rule puts it near 0.40: ROADMAP Queue 3.)"""
    rng = np.random.default_rng(seed)
    fg = rng.random(shape) < 0.3
    x = np.where(fg, rng.normal(0.7, 0.1, shape), rng.normal(0.15, 0.05, shape))
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    flat = x.reshape(shape[0] * shape[1], -1)
    flat[:, 0], flat[:, 1] = 0.0, 1.0
    return flat.reshape(shape)


@pytest.mark.parametrize("case", ["fg_mask", "threshold", "otsu", "otsu-tied", "empty-mask"])
def test_spotlight_loss_matches_jax(case):
    pred, target = _pred_target(1)
    kw, mask = {}, None
    if case == "fg_mask":
        mask = target > 0.6
    elif case == "empty-mask":
        mask = np.zeros_like(target, bool)
        mask[0, 0] = True  # one all-foreground channel, the rest empty
    elif case == "threshold":
        kw = dict(fg_threshold=0.4)
    elif case == "otsu":
        target = _bimodal(target.shape, 1)
    elif case == "otsu-tied":
        target = (target > 0.5).astype(np.float32)  # two values: every split ties
    want = JSpotlightLoss(lambda_mse=0.3, **kw)(jnp.asarray(pred), jnp.asarray(target),
                                                 None if mask is None else jnp.asarray(mask))
    got = SpotlightLoss(lambda_mse=0.3, **kw)(torch.from_numpy(pred), torch.from_numpy(target),
                                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_otsu_thresholds_match_jax_with_tied_maxima():
    target = _bimodal((2, 2, 5, 16, 16), 2)
    target[0, 0] = (target[0, 0] > 0.5)  # tied maxima: the first wins on both sides
    target[1, 1] = 0.25  # constant channel
    want = np.asarray(j_otsu(jnp.asarray(target)))
    got = otsu_threshold_batch(torch.from_numpy(target)).numpy()
    assert got.shape == want.shape == (2, 2, 1, 1, 1)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].item() < 0.01  # the first tied bin, not the last


def test_training_loss_routes_fg_mask_to_spotlight(params):
    """``VSUNet.training_loss`` on an fg_mask batch: the loss and every
    parameter gradient against ``jax.grad`` of the JAX engine's."""
    batch = _batch(3, mask=True)
    jmod = _jax_engine(params, loss=JSpotlightLoss())

    @jax.jit
    def value_and_grad(p, b):
        return jax.value_and_grad(lambda p: jmod.training_loss({"params": p}, b, jax.random.PRNGKey(0))[0])(p)

    jloss, jgrads = value_and_grad(jax.tree_util.tree_map(jnp.asarray, params),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    tmod = _torch_engine(params, loss=SpotlightLoss())
    loss = tmod.training_loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in tmod.model.named_parameters():
        if name not in UNBRIDGED:
            assert_rel_close(p.grad.numpy(), want[name].numpy(), 2e-3, 0.9999)


def test_training_refuses_encoder_drop_path(params):
    """Stochastic depth is not ported: training a model that asks for it
    raises, while its eval-mode loss (no drop path on either side) equals
    that of the same weights at rate 0, to 1e-6 relative."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    tmod = _torch_engine(params)
    tmod.model_config["encoder_drop_path_rate"] = 0.1
    with pytest.raises(NotImplementedError, match="encoder_drop_path_rate"):
        tmod.training_loss(batch)
    tmod.eval()
    with torch.no_grad():
        got = float(tmod.validation_loss(batch))
        want = float(_torch_engine(params).eval().validation_loss(batch))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(mode="max"), dict(save_last=False), dict(filename="{epoch}")],
                         ids=["mode-max", "no-last", "filename"])
def test_model_checkpoint_refuses_options_the_trainer_does_not_honour(kw):
    with pytest.raises(NotImplementedError):
        ModelCheckpoint(monitor="loss/validate", **kw)


# -- validation, optimizer features, logging and hooks against the JAX Trainer -------


def test_validate_mean_loss_matches_jax_trainer(params, tmp_path):
    val = [_batch(10 + i) for i in range(3)]
    jtrainer = JTrainer(default_root_dir=tmp_path / "jax", use_tensorboard=False)
    jmod = _jax_engine(params)
    jtrainer.state = jtrainer._init_state(jmod, None, 1)
    want = jtrainer.validate(jmod, _Data([], val))
    got = Trainer(default_root_dir=tmp_path / "port", device="cpu").validate(_torch_engine(params), _Data([], val))
    assert set(got) == set(want) == {"loss/validate"}
    np.testing.assert_allclose(got["loss/validate"], want["loss/validate"], rtol=1e-5)


@pytest.mark.parametrize("algorithm,value", [("norm", 0.05), ("value", 2e-4)])
def test_clipped_steps_match_jax_trainer(params, tmp_path, algorithm, value):
    train = [_batch(20), _batch(21)]
    tmod = _torch_engine(params)
    tmod.training_loss({k: torch.from_numpy(v) for k, v in train[0].items()}).backward()
    grads = [p.grad for p in tmod.parameters() if p.grad is not None]
    size = torch.sqrt(sum((g**2).sum() for g in grads)) if algorithm == "norm" else max(g.abs().max() for g in grads)
    assert float(size) > 2 * value  # the clip bites
    kw = dict(max_steps=2, gradient_clip_val=value, gradient_clip_algorithm=algorithm)
    jtrainer = jax_fit(params, tmp_path / "jax", train, **kw)
    _, tmod = port_fit(params, tmp_path / "port", train, **kw)
    _assert_params_match(jtrainer, tmod)


def test_accumulated_steps_match_jax_trainer(params, tmp_path):
    """Four mini-steps at ``accumulate_grad_batches=2``: two AdamW updates on
    the mean of each pair's gradients; ``global_step`` counts mini-steps,
    AdamW and the schedule count updates."""
    train = [_batch(30 + i) for i in range(4)]
    kw = dict(max_steps=4, accumulate_grad_batches=2)
    jtrainer = jax_fit(params, tmp_path / "jax", train, **kw)
    trainer, tmod = port_fit(params, tmp_path / "port", train, **kw)
    assert trainer.global_step == jtrainer.global_step == 4
    assert trainer.scheduler.last_epoch == 2
    assert {float(s["step"]) for s in trainer.optimizer.state_dict()["state"].values()} == {2.0}
    _assert_params_match(jtrainer, tmod)


def test_frozen_encoder_matches_jax_trainer(params, tmp_path):
    train = [_batch(40), _batch(41)]
    kw = dict(max_steps=2)
    jtrainer = jax_fit(params, tmp_path / "jax", train, engine_kw=dict(freeze_encoder=True), **kw)
    before = {n: p.detach().clone() for n, p in _torch_engine(params).model.named_parameters()}
    trainer, tmod = port_fit(params, tmp_path / "port", train, engine_kw=dict(freeze_encoder=True), **kw)
    in_opt = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in in_opt for n, p in tmod.model.named_parameters() if n.startswith("encoder."))
    _assert_params_match(jtrainer, tmod, frozen_unchanged_from=before)
    assert not torch.equal(tmod.model.state_dict()["decoder.decoder_stages.0.conv.blocks.0.mlp.fc1.weight"],
                           before["decoder.decoder_stages.0.conv.blocks.0.mlp.fc1.weight"])


HOOKS = ["on_fit_start", "on_train_epoch_start", "on_train_batch_end", "on_validation_epoch_start",
         "on_validation_batch_end", "on_validation_epoch_end", "on_train_epoch_end", "on_fit_end"]


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.events = []

    for hook in HOOKS:
        setattr(Recorder, hook, lambda self, *a, _h=hook: self.events.append(_h))
    return Recorder()


@pytest.fixture(scope="module")
def fit_pair(params, tmp_path_factory):
    """Two epochs of two of the three train batches, validation (one of
    the two val batches) every second epoch, every step logged, on each
    side with a recording callback."""
    root = tmp_path_factory.mktemp("fit_pair")
    train = [_batch(50), _batch(51), _batch(54)]
    val = [_batch(52), _batch(53)]
    jrec, trec = _recorder(JCallback), _recorder(Callback)
    kw = dict(max_epochs=2, limit_train_batches=2, limit_val_batches=1, check_val_every_n_epoch=2,
              log_every_n_steps=1)
    jtrainer = jax_fit(params, root / "jax", train, val, callbacks=[jrec], **kw)
    trainer, tmod = port_fit(params, root / "port", train, val, callbacks=[trec], **kw)
    lines = {side: [json.loads(s) for s in (root / side / "metrics.csv").read_text().splitlines()]
             for side in ("jax", "port")}
    return dict(jax=jtrainer, port=trainer, tmod=tmod, jrec=jrec, trec=trec, lines=lines)


def test_metrics_csv_has_the_jax_keys_and_values(fit_pair):
    """Batch limits and the validation cadence give JAX's steps and lines."""
    jl, tl = fit_pair["lines"]["jax"], fit_pair["lines"]["port"]
    assert fit_pair["port"].global_step == fit_pair["jax"].global_step == 4
    assert [sorted(line) for line in tl] == [sorted(line) for line in jl]
    assert [line["step"] for line in tl] == [line["step"] for line in jl] == [1, 2, 3, 4, 4]
    for j, t in zip(jl, tl):
        for key in ("loss/train", "loss/validate", "lr"):
            if key in j:
                np.testing.assert_allclose(t[key], j[key], rtol=1e-5, err_msg=key)


def test_callback_hooks_run_in_the_jax_order(fit_pair):
    assert fit_pair["trec"].events == fit_pair["jrec"].events
    assert fit_pair["trec"].events.count("on_validation_batch_end") == 1
    assert fit_pair["trec"].events.count("on_train_batch_end") == 4


# -- checkpoints ------------------------------------------------------------------


def _save_with_scores(trainer, tmod, scores):
    paths = []
    for epoch, score in enumerate(scores):
        trainer.current_epoch, trainer.global_step = epoch, 10 * (epoch + 1)
        paths.append(trainer._save_checkpoint(tmod, {"loss/validate": score}))
    return paths


def test_checkpoint_names_top_k_pruning_and_last(params, tmp_path):
    """JAX's names and rules: ``epoch=E-step=S-loss=L``, ``last`` links to
    the newest, top-k by the monitored value, ``last``'s target kept."""
    trainer, tmod = port_fit(params, tmp_path, [_batch(60)], max_steps=1, checkpoint_top_k=2)
    paths = _save_with_scores(trainer, tmod, [0.3, 0.1, 0.2, 0.9])
    ckpts = tmp_path / "checkpoints"
    assert paths[0].name == "epoch=0-step=10-loss=0.300"
    assert sorted(p.name for p in ckpts.iterdir()) == sorted(
        ["epoch=1-step=20-loss=0.100", "epoch=2-step=30-loss=0.200", "epoch=3-step=40-loss=0.900", "last"])
    assert (ckpts / "last").resolve() == paths[3].absolute()
    _save_with_scores(trainer, tmod, [0.05])
    assert not paths[3].exists()  # no longer last's target: pruned
    trainer.default_root_dir = tmp_path / "other"
    trainer._ckpt_scores = []
    saved = trainer._save_checkpoint(tmod, {})
    assert saved.name == f"epoch=0-step=10" and (tmp_path / "other" / "checkpoints" / "last").exists()


def test_checkpoint_round_trip_and_resume_are_bit_exact(params, tmp_path):
    """Two epochs with validation and ModelCheckpoint, then a new trainer
    and engine load ``last``: weights, AdamW and scheduler state equal
    bit for bit; the fit resumes at the saved epoch + 1 and step."""
    train, val = [_batch(70), _batch(71)], [_batch(72)]
    cb = [ModelCheckpoint(monitor="loss/validate", save_top_k=5), LearningRateMonitor()]
    trainer, tmod = port_fit(params, tmp_path, train, val, callbacks=cb, max_epochs=2,
                             checkpoint_every_n_epochs=5)
    assert trainer.checkpoint_every_n_epochs == 1  # set by ModelCheckpoint at fit start
    last = tmp_path / "checkpoints" / "last"
    assert last.resolve().name.startswith("epoch=1-step=4-loss=")
    fresh = _torch_engine(params)
    other = Trainer(default_root_dir=tmp_path / "resume", max_epochs=3, seed=0, device="cpu")
    epochs = []

    class Epochs(Callback):
        def on_train_epoch_start(self, trainer, module, epoch):
            epochs.append((epoch, trainer.global_step))
            if epoch == 2:
                for (n, a), b in zip(module.model.state_dict().items(), tmod.model.state_dict().values()):
                    assert torch.equal(a, b), n
                _assert_optimizer_states_equal(trainer.optimizer.state_dict(), trainer_state)

    trainer_state = trainer.optimizer.state_dict()
    other.callbacks = [Epochs()]
    other.fit(fresh, _Data(train, val), ckpt_path=last)
    assert epochs == [(2, 4)] and other.global_step == 6
    assert other.scheduler.last_epoch == 6
    assert (tmp_path / "resume" / "checkpoints" / "last").resolve().name.startswith("epoch=2-step=6-")


def _assert_optimizer_states_equal(a, b):
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        for name, v in a["state"][k].items():
            assert torch.equal(v, b["state"][k][name]), (k, name)


def test_port_checkpoint_loads_through_the_jax_converter(params, tmp_path):
    """``viscy_tpu.training.convert.load_torch_checkpoint`` +
    ``convert_fcmae_state_dict`` read a port checkpoint; the JAX forward
    on those weights equals the port's (torch-parity bound)."""
    trainer, tmod = port_fit(params, tmp_path, [_batch(80)], max_steps=1, checkpoint_every_n_epochs=1)
    state = jconvert.load_torch_checkpoint(str(tmp_path / "checkpoints" / "last"))
    assert all(k.startswith("model.") for k in state)
    jparams = jconvert.convert_fcmae_state_dict(state)
    x = _batch(81)["source"]
    want = JFCMAE(**TINY).apply({"params": jparams}, jnp.asarray(x))
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert_rel_close(got.numpy(), np.asarray(want), 2e-3, 0.9999)


@pytest.mark.parametrize("layout", ["lightning-weights", "bare-state-dict", "optimizer-mismatch"])
def test_weights_only_checkpoint_keeps_the_fresh_optimizer(params, tmp_path, layout, caplog):
    trainer, tmod = port_fit(params, tmp_path, [_batch(90)], max_steps=1, checkpoint_every_n_epochs=1)
    payload = torch.load(tmp_path / "checkpoints" / "last", weights_only=True)
    if layout == "lightning-weights":
        path, payload = tmp_path / "w.ckpt", {"state_dict": payload["state_dict"]}
        torch.save(payload, path)
    elif layout == "bare-state-dict":
        path = tmp_path / "w.pt"
        torch.save({k[len("model."):]: v for k, v in payload["state_dict"].items()}, path)
    else:
        path = tmp_path / "checkpoints" / "last"
    fresh = _torch_engine(params, freeze_encoder=layout == "optimizer-mismatch")
    other = Trainer(default_root_dir=tmp_path / "o", device="cpu")
    other.optimizer, other.scheduler, other._schedule = fresh.configure_optimizers(10)
    with caplog.at_level(logging.WARNING, logger="viscy_tpu_torch"):
        other.load_checkpoint(path, fresh)
    for (n, a), b in zip(fresh.model.state_dict().items(), tmod.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert other.optimizer.state_dict()["state"] == {}
    assert other.scheduler.last_epoch == 0
    if layout == "optimizer-mismatch":
        assert "weights only" in caplog.text
        assert (other.current_epoch, other.global_step) == (1, 1)
    else:
        assert (other.current_epoch, other.global_step) == (0, 0)


def test_last_pointing_at_a_pruned_checkpoint_raises(params, tmp_path):
    trainer, tmod = port_fit(params, tmp_path, [_batch(91)], max_steps=1, checkpoint_every_n_epochs=1)
    last = tmp_path / "checkpoints" / "last"
    last.resolve().unlink()
    with pytest.raises(FileNotFoundError, match="no longer exists"):
        trainer.load_checkpoint(last, tmod)


# -- the recipe end to end on the CPU, and the rest of the trainer's surface ----------


def _recipe_aug(keys):
    return T.Compose([
        T.NormalizeSampled(keys=["source", "target"], level="fov_statistics"),
        T.BatchedRandFlipd(keys=keys, prob=0.5),
        T.BatchedRandAffined(keys=keys, prob=0.5, rotate_range=[3.14, 0.0, 0.0],
                             scale_range=[[1.0, 1.3], [0.75, 1.3], [0.75, 1.3]]),
        T.BatchedRandAdjustContrastd(keys=["source"], gamma=[0.8, 1.2], prob=0.3),
        T.BatchedRandGaussianNoised(keys=["source"], prob=0.5, std=0.5),
    ])


def _with_meta(batch, seed):
    rng = np.random.default_rng(seed)
    n = batch["source"].shape[0]
    meta = {k: {"fov_statistics": {"mean": rng.random(n).astype(np.float32),
                                   "std": 0.5 + rng.random(n).astype(np.float32)}}
            for k in ("source", "target")}
    return dict(batch, norm_meta=meta)


@pytest.mark.parametrize("loss", ["mixed", "spotlight-fg_mask"])
def test_recipe_fit_and_resume_run_on_the_cpu(params, tmp_path, loss):
    """The VSCyto3D fit recipe through ``Trainer(device="cpu")``:
    NormalizeSampled and the config's flip, affine, contrast and noise,
    validation, ModelCheckpoint, LearningRateMonitor, the CSV log,
    clipping, accumulation and freeze_encoder; then a resume from ``last``."""
    spot = loss != "mixed"
    keys = ["source", "target", "fg_mask"] if spot else ["source", "target"]

    class Recipe(DeviceTransformDataModule):
        train_device_transforms = _recipe_aug(keys)

        def train_dataloader(self):
            return [_with_meta(_batch(100 + i, mask=spot), i) for i in range(2)]

        def val_dataloader(self):
            return [_with_meta(_batch(110, mask=spot), 9)]

    def engine():
        return _torch_engine(params, loss=SpotlightLoss() if spot else None, freeze_encoder=True)

    tmod = engine()
    frozen = tmod.model.encoder.stem.conv3d.weight.detach().clone()
    kw = dict(default_root_dir=tmp_path, seed=3, log_every_n_steps=1, gradient_clip_val=0.5,
              accumulate_grad_batches=2, device="cpu")
    trainer = Trainer(max_epochs=2, callbacks=[ModelCheckpoint(save_top_k=5), LearningRateMonitor()], **kw)
    trainer.fit(tmod, Recipe())
    assert trainer.global_step == 4 and trainer.scheduler.last_epoch == 2
    assert torch.equal(tmod.model.encoder.stem.conv3d.weight, frozen)
    lines = [json.loads(s) for s in (tmp_path / "metrics.csv").read_text().splitlines()]
    assert any("loss/validate" in line for line in lines) and any("lr" in line for line in lines)
    assert all(np.isfinite(v) for line in lines for v in line.values())
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert len(names) == 3 and names[-1] == "last" and names[0].startswith("epoch=0-step=2-loss=")
    resumed = Trainer(max_epochs=3, **kw)
    fresh = engine()
    resumed.fit(fresh, Recipe(), ckpt_path=tmp_path / "checkpoints" / "last")
    assert resumed.global_step == 6 and resumed.current_epoch == 2
    assert torch.equal(fresh.model.encoder.stem.conv3d.weight, frozen)


def test_fit_without_validation_keeps_the_train_augmentation_stream(params, tmp_path):
    """Validation draws from a generator of its own: the train batches'
    augmentation, and so the weights, are the same with or without a val
    loader (the val transform here is random too)."""
    aug = T.Compose([T.BatchedRandGaussianNoised(keys=["source"], prob=1.0, std=0.1)])

    class Noisy(DeviceTransformDataModule):
        train_device_transforms = aug
        val_device_transforms = aug

        def __init__(self, val):
            self.val = val

        def train_dataloader(self):
            return [_batch(120), _batch(121)]

        def val_dataloader(self):
            return [_batch(122)] if self.val else None

    runs = []
    for val in (True, False):
        tmod = _torch_engine(params)
        trainer = Trainer(max_epochs=2, default_root_dir=tmp_path / str(val), device="cpu")
        trainer.fit(tmod, Noisy(val))
        runs.append(tmod.model.state_dict())
    for name, a in runs[0].items():
        assert torch.equal(a, runs[1][name]), name


def test_clip_by_global_norm_then_adamw_matches_optax():
    """``clip_by_global_norm_`` before the AdamW step is
    ``optax.chain(optax.clip_by_global_norm(c), optax.adamw(...))`` on a
    gradient above the bound and one below it, to 1e-6."""
    import optax

    rng = np.random.default_rng(5)
    w = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    gs = [[rng.normal(size=x.shape).astype(np.float32) * s for x in w] for s in (3.0, 0.01)]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(1e-2, weight_decay=1e-2))
    jp = [jnp.asarray(x) for x in w]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in w]
    opt, sched, _ = configure_adamw_scheduler(tp, lr=1e-2)
    for g in gs:  # the first clipped, the second not
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        clip_by_global_norm_(tp, 0.5)
        opt.step()
        sched.step()
    for p, x in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(x), atol=1e-6, rtol=0)


def test_tensorboard_is_refused_and_the_profiler_writes_a_trace(params, tmp_path):
    with pytest.raises(NotImplementedError, match="TensorBoard"):
        CSVLogger(tmp_path, use_tensorboard=True)
    with pytest.raises(NotImplementedError):
        Trainer(use_tensorboard=True, device="cpu")
    trainer, _ = port_fit(params, tmp_path, [_batch(130)] * 4, max_steps=4, profile_dir=str(tmp_path / "prof"),
                          profile_steps=(1, 2))
    assert [p.name for p in (tmp_path / "prof").iterdir()] == ["trace_steps_1-2.json"]
    events = json.loads((tmp_path / "prof" / "trace_steps_1-2.json").read_text())["traceEvents"]
    assert sum(e.get("name", "").startswith("Optimizer.step#AdamW") for e in events) == 2  # steps 1 and 2



def test_fast_dev_run_logs_one_step_and_validation_and_saves_nothing(params, tmp_path):
    train, val = [_batch(140 + i) for i in range(3)], [_batch(150), _batch(151)]
    dev, _ = port_fit(params, tmp_path, train, val, fast_dev_run=True, max_epochs=5,
                      checkpoint_every_n_epochs=1)
    logged = [json.loads(s) for s in (tmp_path / "metrics.csv").read_text().splitlines()]
    assert dev.global_step == 1 and [sorted(x) for x in logged] == [
        ["loss/train", "lr", "step", "step_time_ms"], ["loss/validate", "step"]]
    assert not (tmp_path / "checkpoints").exists()
