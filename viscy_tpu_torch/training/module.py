"""TrainModule: the engine protocol (counterpart of
``viscy_tpu/training/module.py``), prediction-facing part.

An engine is an ``nn.Module`` that owns its model and parameters; the
trainer calls its steps with batches already on the engine's device.
"""

from __future__ import annotations

from typing import Any

from torch import nn


class TrainModule(nn.Module):
    """Base engine. Subclasses set ``self.model`` and implement the steps."""

    model: nn.Module

    def predict_step(self, batch: dict) -> Any:
        raise NotImplementedError
