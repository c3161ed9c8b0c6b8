"""Trainer (counterpart of ``viscy_tpu/training/trainer.py``): the fit loop
and the predict loop.

PyTorch runs eagerly, so there is no compiled step. A fit step moves the
batch to the trainer's device, runs the datamodule's device transform with
the trainer's seeded ``torch.Generator``, then ``training_loss``,
``backward``, ``optimizer.step`` and ``scheduler.step``. Validation,
checkpoints, gradient clipping and accumulation, and the CSV logger are not
ported.
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.training.callbacks.base import Callback
from viscy_tpu_torch.training.module import TrainModule


def _to_device(batch: dict, device: torch.device) -> dict:
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if isinstance(value, torch.Tensor):
            value = value.to(device, non_blocking=True)
        out[key] = value
    return out


class Trainer:
    """Drives TrainModule engines over DataModules on one device.

    ``max_steps`` ends the fit (and sets the schedule's length); without it
    the fit runs ``max_epochs`` passes over ``train_dataloader()``, whose
    length (or the datamodule's ``steps_per_epoch``) sets the schedule.
    Every ``log_every_n_steps`` steps ``logged_metrics`` takes the step's
    loss, learning rate and mean step time (reading the loss waits for the
    device). The augmentation generator is seeded with ``seed + 1``.
    """

    def __init__(
        self,
        max_epochs: int = 1,
        max_steps: int | None = None,
        callbacks: Sequence[Callback] | None = None,
        log_every_n_steps: int = 10,
        seed: int = 42,
        device: str | torch.device = "cuda",
    ) -> None:
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.callbacks = list(callbacks or [])
        self.log_every_n_steps = log_every_n_steps
        self.seed = seed
        self.device = resolve_device(device)
        self.optimizer = None
        self.scheduler = None
        self._schedule = None
        self.generator: torch.Generator | None = None
        self.current_epoch = 0
        self.global_step = 0
        self.logged_metrics: dict[str, float] = {}

    def _total_steps(self, datamodule, loader) -> int:
        if self.max_steps:
            return self.max_steps
        try:
            steps_per_epoch = len(loader)
        except TypeError:
            steps_per_epoch = getattr(datamodule, "steps_per_epoch", None)
            if steps_per_epoch is None:
                raise ValueError(
                    "train_dataloader has no len() and the datamodule defines no "
                    "steps_per_epoch: set one of them or Trainer(max_steps=...)"
                ) from None
        return steps_per_epoch * self.max_epochs

    def fit(self, module: TrainModule, datamodule) -> None:
        """Train ``module`` on ``datamodule.train_dataloader()`` batches."""
        prepare = getattr(datamodule, "prepare_data", None)
        if prepare is not None:
            prepare()
        datamodule.setup("fit")
        module.to(self.device).train()
        if self.optimizer is None:
            total = self._total_steps(datamodule, datamodule.train_dataloader())
            self.optimizer, self.scheduler, self._schedule = module.configure_optimizers(total)
            self.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        transform = getattr(datamodule, "device_transform", None)
        for cb in self.callbacks:
            cb.on_fit_start(self, module)
        step_t0 = time.perf_counter()
        done = False
        for epoch in range(self.current_epoch, self.max_epochs):
            self.current_epoch = epoch
            for i, batch in enumerate(datamodule.train_dataloader()):
                batch = _to_device(batch, self.device)
                if transform is not None:
                    batch = transform(batch, self.generator, "train")
                loss = module.training_loss(batch)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                self.optimizer.step()
                self.scheduler.step()
                self.global_step += 1
                metrics = {"loss/train": loss.detach()}
                if self.global_step % self.log_every_n_steps == 0:
                    now = time.perf_counter()
                    self.logged_metrics.update(
                        {
                            "loss/train": float(loss),
                            "lr": float(self._schedule(self.global_step)),
                            "step_time_ms": (now - step_t0) / self.log_every_n_steps * 1e3,
                        }
                    )
                    step_t0 = now
                for cb in self.callbacks:
                    cb.on_train_batch_end(self, module, metrics, batch, i)
                if self.max_steps and self.global_step >= self.max_steps:
                    done = True
                    break
            if done:
                break
        for cb in self.callbacks:
            cb.on_fit_end(self, module)

    def predict(
        self, module: TrainModule, datamodule, return_predictions: bool = False
    ) -> list[Any] | None:
        """Run ``module.predict_step`` over ``datamodule.predict_dataloader()``
        under ``torch.inference_mode()``.

        Batches are dicts of tensors (or numpy arrays); each is moved to the
        trainer's device. Predictions stay where the step put them.
        """
        prepare = getattr(datamodule, "prepare_data", None)
        if prepare is not None:
            prepare()
        datamodule.setup("predict")
        module.to(self.device).eval()
        for cb in self.callbacks:
            cb.on_predict_start(self, module)
        outputs = []
        with torch.inference_mode():
            for i, batch in enumerate(datamodule.predict_dataloader()):
                pred = module.predict_step(_to_device(batch, self.device))
                for cb in self.callbacks:
                    cb.write_on_batch_end(self, module, pred, batch, i)
                if return_predictions:
                    outputs.append(pred)
        for cb in self.callbacks:
            cb.on_predict_end(self, module)
        return outputs if return_predictions else None
