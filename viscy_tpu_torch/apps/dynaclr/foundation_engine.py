"""Foundation-model embedding engine (counterpart of
``viscy_tpu/apps/dynaclr/foundation_engine.py``; reference
``dynaclr/foundation_engine.py``): a frozen feature extractor behind the
predict-only engine surface, so ``viscy-torch predict`` with the
``EmbeddingWriter`` runs it as it runs the contrastive engine."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.training.module import TrainModule

__all__ = ["FoundationModule"]


class _ZeroUpdates(torch.optim.Optimizer):
    """An optimizer whose step changes nothing (``optax.set_to_zero()``)."""

    def __init__(self, params) -> None:
        super().__init__(list(params) or [torch.zeros(())], {"lr": 0.0})

    def step(self, closure=None):
        return None if closure is None else closure()


class FoundationModule(TrainModule):
    """Predict-only engine over a frozen foundation model (``model``: an
    ``nn.Module`` returning ``(features, projections)``, or its
    ``class_path`` / ``init_args`` node). ``predict_step`` returns
    ``{"features", "projections"}`` of ``batch["anchor"]``. Its parameters
    are frozen and its optimizer changes nothing, as the JAX engine's
    ``optax.set_to_zero()``; it has no training loss. ``device`` defaults
    to ``"cuda"``."""

    def __init__(self, model, example_input_array_shape: Sequence[int] = (1, 1, 1, 224, 224),
                 device: str | torch.device = "cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        if isinstance(model, dict):
            from viscy_tpu_torch.training.instantiate import instantiate

            model = instantiate(model)
        self.model = model.to(device)
        self.model.requires_grad_(False)
        self.example_input_array_shape = tuple(example_input_array_shape)

    def example_input(self) -> dict:
        return {"anchor": np.zeros(self.example_input_array_shape, np.float32)}

    def predict_step(self, batch: dict) -> dict:
        features, projections = self.model(batch["anchor"])
        return {"features": features, "projections": projections}

    def configure_optimizers(self, total_steps: int):
        opt = _ZeroUpdates(self.parameters())
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 0.0), (lambda step: 0.0)
