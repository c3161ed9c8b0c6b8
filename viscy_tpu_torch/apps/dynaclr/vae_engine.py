"""Beta-VAE engine with KL annealing (counterpart of
``viscy_tpu/apps/dynaclr/vae_engine.py``; reference ``dynaclr/engine.py:348``
``BetaVaeModule``)."""

from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
import torch
from torch import nn

from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.schedule import cosine_anneal
from viscy_tpu_torch.models.vae.beta_vae_25d import BetaVae25D, vae_loss
from viscy_tpu_torch.training.module import TrainModule


class BetaVaeModule(TrainModule):
    """Train a VAE on a batch's ``anchor`` (else its ``source``) patches,
    reconstructing them, with a KL weight ``current_beta``: ``beta``, or
    with ``beta_schedule="cosine"`` annealed from ``beta_start`` to ``beta``
    over ``beta_warmup_epochs`` (set in :meth:`on_epoch_start`).

    ``vae`` is a VAE module (a :class:`BetaVae25D` or ``BetaVaeConv``, also
    as a ``class_path`` node), the keyword arguments of a
    :class:`BetaVae25D`, or None for its defaults; built from a generator
    seeded with ``seed`` on ``device`` (``"cuda"`` by default). In training
    the latent's noise (and any drop path) is drawn from the trainer's
    generator, or given as ``eps``. ``predict_step`` returns
    ``{"features": mean, "projections": z}`` (``z`` is the mean in eval) for
    the ``EmbeddingWriter``."""

    def __init__(
        self,
        vae: nn.Module | dict | None = None,
        beta: float = 1.0,
        beta_schedule: Literal["cosine", "constant"] = "constant",
        beta_start: float = 0.0,
        beta_warmup_epochs: int = 50,
        lr: float = 1e-4,
        schedule: Literal["WarmupCosine", "Constant"] = "Constant",
        example_input_array_shape: Sequence[int] = (1, 2, 16, 128, 128),
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        if not isinstance(vae, nn.Module):
            cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in (vae or {}).items()}
            vae = BetaVae25D(**cfg, generator=torch.Generator().manual_seed(seed))
        self.model = vae.to(device)
        self.beta_final = beta
        self.beta_schedule = beta_schedule
        self.beta_start = beta_start
        self.beta_warmup_epochs = beta_warmup_epochs
        self.current_beta = beta_start if beta_schedule == "cosine" else beta
        self.lr = lr
        self.schedule = schedule
        self.example_input_array_shape = tuple(example_input_array_shape)

    def on_epoch_start(self, epoch: int) -> None:
        if self.beta_schedule == "cosine":
            self.current_beta = cosine_anneal(self.beta_start, self.beta_final, epoch, self.beta_warmup_epochs)

    def example_input(self) -> dict:
        return {"anchor": np.zeros(self.example_input_array_shape, np.float32)}

    @staticmethod
    def _batch_input(batch: dict) -> torch.Tensor:
        return batch["anchor"] if "anchor" in batch else batch["source"]

    def training_loss(self, batch: dict, generator: torch.Generator | None = None,
                      eps: torch.Tensor | None = None) -> torch.Tensor:
        """The ELBO at ``current_beta`` of the sampled reconstruction."""
        x = self._batch_input(batch)
        loss, _ = vae_loss(self.model(x, generator=generator, eps=eps), x, beta=self.current_beta)
        return loss

    def validation_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """The ELBO of the deterministic forward (``z`` the mean)."""
        x = self._batch_input(batch)
        loss, _ = vae_loss(self.model(x), x, beta=self.current_beta)
        return loss

    def predict_step(self, batch: dict) -> dict:
        out = self.model(self._batch_input(batch))
        return {"features": out.mean, "projections": out.z}

    def configure_optimizers(self, total_steps: int):
        """AdamW with the engine's schedule (its default warmup)."""
        from viscy_tpu_torch.training.optimizers import configure_adamw_scheduler

        return configure_adamw_scheduler(self.parameters(), lr=self.lr, schedule=self.schedule,
                                         total_steps=total_steps)
