"""Callback protocol (counterpart of ``viscy_tpu/training/callbacks/base.py``),
fit and prediction hooks."""

from __future__ import annotations

from typing import Any


class Callback:
    """Base callback; the hooks mirror the Lightning ones the reference's
    callbacks use."""

    def on_fit_start(self, trainer, module) -> None: ...

    def on_train_batch_end(
        self, trainer, module, metrics: dict, batch: dict, batch_idx: int
    ) -> None: ...

    def on_fit_end(self, trainer, module) -> None: ...

    def on_predict_start(self, trainer, module) -> None: ...

    def write_on_batch_end(
        self, trainer, module, prediction: Any, batch: dict, batch_idx: int
    ) -> None: ...

    def on_predict_end(self, trainer, module) -> None: ...
