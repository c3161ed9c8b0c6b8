"""Trainer (counterpart of ``viscy_tpu/training/trainer.py``), predict loop.

PyTorch runs eagerly, so there is no compiled step: the trainer moves each
batch to its device and calls the engine's ``predict_step`` under
``torch.inference_mode()``.
"""

from __future__ import annotations

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
    """Drives TrainModule engines over DataModules on one device."""

    def __init__(
        self, callbacks: Sequence[Callback] | None = None, device: str | torch.device = "cuda"
    ) -> None:
        self.callbacks = list(callbacks or [])
        self.device = resolve_device(device)

    def predict(
        self, module: TrainModule, datamodule, return_predictions: bool = False
    ) -> list[Any] | None:
        """Run ``module.predict_step`` over ``datamodule.predict_dataloader()``.

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
