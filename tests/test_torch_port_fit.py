"""The port's trainer features (validation, checkpoints and resume, the
CSV logger, hooks, gradient clipping and accumulation, freeze_encoder, the
profiler and fast_dev_run) against viscy_tpu's own ``Trainer``.

The tiny FCMAE of tests/_torch_port_fit_common.py with seeded JAX weights
in both packages, on numpy-seeded batches with no random transforms, TF32
off. Tolerances, float32: losses to 1e-5 relative; parameters after the
steps to 1e-5 absolute (1 % of lr = 1e-3, see test_torch_port_train.py);
frozen parameters, checkpoint round trips and resumed state bit for bit.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training import convert as jconvert
from viscy_tpu.training.callbacks.base import Callback as JCallback
from viscy_tpu.training.trainer import Trainer as JTrainer
from viscy_tpu_torch import transforms as T
from viscy_tpu_torch.data.gpu_aug import DeviceTransformDataModule
from viscy_tpu_torch.training.callbacks.base import Callback
from viscy_tpu_torch.training.callbacks.checkpoint import LearningRateMonitor, ModelCheckpoint
from viscy_tpu_torch.training.trainer import CSVLogger, Trainer

from _torch_port_fit_common import (  # noqa: F401  (fixtures)
    TINY,
    _assert_params_match,
    _batch,
    _Data,
    _jax_engine,
    _no_tf32,
    _torch_engine,
    jax_fit,
    params,
    port_fit,
)
from _torch_port_helpers import assert_rel_close


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


def test_tensorboard_is_refused_and_the_profiler_writes_a_trace(params, tmp_path):
    """TensorBoard is no longer refused: on by default, as in JAX, each
    logger writes one event file beside metrics.csv (its contents are held
    against tensorboardX's in test_torch_port_loggers.py)."""
    logger = CSVLogger(tmp_path / "tb", use_tensorboard=True)
    logger.log_metrics({"loss/train": 0.5}, 3)
    logger.close()
    assert len(list((tmp_path / "tb").glob("events.out.tfevents.*"))) == 1
    assert Trainer(device="cpu", default_root_dir=tmp_path / "unused").logger.use_tensorboard
    trainer, _ = port_fit(params, tmp_path, [_batch(130)] * 4, max_steps=4, profile_dir=str(tmp_path / "prof"),
                          profile_steps=(1, 2), log_every_n_steps=2)
    assert len(list(tmp_path.glob("events.out.tfevents.*"))) == 1
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
