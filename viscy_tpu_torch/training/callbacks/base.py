"""Callback protocol (counterpart of ``viscy_tpu/training/callbacks/base.py``):
fit, epoch, validation, test and prediction hooks."""

from __future__ import annotations

from typing import Any


class Callback:
    """Base callback; the hooks mirror the Lightning ones the reference's
    callbacks use. ``Trainer.fit`` calls them in this order: ``on_fit_start``;
    per epoch ``on_train_epoch_start``, ``on_train_batch_end`` per step, then
    (on a validation epoch) ``on_validation_epoch_start``,
    ``on_validation_batch_end`` per batch and ``on_validation_epoch_end``,
    then ``on_train_epoch_end``; last ``on_fit_end``. ``Trainer.test`` calls
    ``on_test_batch_end`` per batch with its host metrics, then
    ``on_test_end`` with their means."""

    def on_fit_start(self, trainer, module) -> None: ...

    def on_fit_end(self, trainer, module) -> None: ...

    def on_train_epoch_start(self, trainer, module, epoch: int) -> None: ...

    def on_train_batch_end(
        self, trainer, module, outputs: dict, batch: dict, batch_idx: int
    ) -> None: ...

    def on_train_epoch_end(self, trainer, module, epoch: int) -> None: ...

    def on_validation_epoch_start(self, trainer, module) -> None: ...

    def on_validation_batch_end(
        self, trainer, module, outputs: dict, batch: dict, batch_idx: int
    ) -> None: ...

    def on_validation_epoch_end(self, trainer, module, metrics: dict) -> None: ...

    def on_predict_start(self, trainer, module) -> None: ...

    def write_on_batch_end(
        self, trainer, module, prediction: Any, batch: dict, batch_idx: int
    ) -> None: ...

    def on_predict_end(self, trainer, module) -> None: ...

    def on_test_batch_end(
        self, trainer, module, outputs: dict, batch: dict, batch_idx: int
    ) -> None: ...

    def on_test_end(self, trainer, module, metrics: dict) -> None: ...
