"""TrainModule: the engine protocol (counterpart of
``viscy_tpu/training/module.py``).

An engine is an ``nn.Module`` that owns its model and parameters; the
trainer calls its steps with batches already on the engine's device. There
is no counterpart of ``viscy_tpu/training/state.py``: the engine holds the
parameters and the optimizer built by ``configure_optimizers`` holds the
optimizer state.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn


class TrainModule(nn.Module):
    """Base engine. Subclasses set ``self.model`` and implement the steps."""

    model: nn.Module

    def training_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """The scalar training loss of one (augmented) batch, differentiable
        in the engine's parameters; ``generator`` (on the batch's device) is
        the only source of the step's random draws, such as stochastic
        depth and token masks."""
        raise NotImplementedError

    def validation_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """The scalar validation loss of one batch (the trainer calls it in
        eval mode under ``torch.no_grad()``); ``generator`` is the only
        source of its random draws, such as token masks."""
        raise NotImplementedError

    def predict_step(self, batch: dict) -> Any:
        raise NotImplementedError

    def load_pretrained(self) -> None:
        """Change the freshly built weights before training, e.g. load a
        pretrained part (the trainer calls it once, before it builds the
        optimizer and before it loads a checkpoint to resume from)."""

    def configure_optimizers(self, total_steps: int):
        """``(optimizer, lr_scheduler, schedule_fn)`` over ``self.parameters()``;
        the default is AdamW at a constant 2e-4."""
        from viscy_tpu_torch.training.optimizers import configure_adamw_scheduler

        return configure_adamw_scheduler(self.parameters(), total_steps=total_steps)

    def on_epoch_start(self, epoch: int) -> None:
        """Per-epoch hook, called before the epoch's first step."""

    def checkpoint_state(self) -> dict:
        """Engine state beyond ``model``'s weights that a checkpoint carries
        (nested dicts of tensors and numbers, such as a GAN's discriminator,
        its spectral-norm vectors, the EMA generator and counters); the
        trainer saves it as ``engine_state`` and hands it back to
        :meth:`load_checkpoint_state` when it loads the checkpoint. None
        by default."""
        return {}

    def load_checkpoint_state(self, state: dict) -> None:
        """Restore what :meth:`checkpoint_state` returned."""
