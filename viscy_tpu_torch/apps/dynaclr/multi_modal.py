"""Cross-modal joint encoders (counterpart of
``viscy_tpu/apps/dynaclr/multi_modal.py``; reference
``dynaclr/multi_modal.py:17``): two single-channel
:class:`ContrastiveEncoder`\\ s, one a modality, trained by InfoNCE so that
the projections of a cell's source and target channels (e.g. phase and
fluorescence) align.

Batches are ``{"source", "target"}`` as ``HCSDataModule`` yields them. In a
train-mode forward each encoder normalizes its projection's BatchNorms by
its own batch statistics and updates its own running ones, as the JAX step
returns both through ``mutable=["batch_stats"]``.
"""

from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
import torch
from torch import nn

from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.contrastive.encoder import ContrastiveEncoder
from viscy_tpu_torch.models.contrastive.loss import ntxent_loss
from viscy_tpu_torch.training.module import TrainModule


class JointEncoders(nn.Module):
    """Two modality-specific encoders with a shared projection space."""

    def __init__(self, source_encoder: ContrastiveEncoder, target_encoder: ContrastiveEncoder) -> None:
        super().__init__()
        self.source_encoder = source_encoder
        self.target_encoder = target_encoder

    def forward(self, source: torch.Tensor, target: torch.Tensor, generator: torch.Generator | None = None):
        """``((source embedding, projection), (target embedding, projection))``;
        ``generator`` draws both encoders' drop-path masks, source first."""
        return self.source_encoder(source, generator), self.target_encoder(target, generator)


def _encoder(spec: ContrastiveEncoder | dict, seed: int) -> ContrastiveEncoder:
    if isinstance(spec, ContrastiveEncoder):
        return spec
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in spec.items()}
    return ContrastiveEncoder(**cfg, generator=torch.Generator().manual_seed(seed))


class JointEncoderModule(TrainModule):
    """Cross-modal InfoNCE training over paired (source, target) channels.

    Each encoder is a :class:`ContrastiveEncoder` or its keyword arguments
    (the source's weights drawn from a generator seeded with ``seed``, the
    target's with ``seed + 1``), on ``device`` (``"cuda"`` by default, which
    raises without a card). The loss is NT-Xent at ``temperature`` between
    the source and target projections; the optimizer AdamW at ``lr`` with
    the ``Constant`` or ``WarmupCosine`` schedule."""

    def __init__(
        self,
        source_encoder: ContrastiveEncoder | dict,
        target_encoder: ContrastiveEncoder | dict,
        temperature: float = 0.07,
        lr: float = 1e-3,
        schedule: Literal["WarmupCosine", "Constant"] = "Constant",
        example_input_array_shape: Sequence[int] | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.model = JointEncoders(_encoder(source_encoder, seed), _encoder(target_encoder, seed + 1)).to(device)
        self.temperature = temperature
        self.lr = lr
        self.schedule = schedule
        # an explicit shape serves both inputs; else each encoder's own stem
        self.example_input_array_shape = tuple(example_input_array_shape) if example_input_array_shape else None

    def _example_shape(self, encoder: ContrastiveEncoder) -> tuple[int, ...]:
        if self.example_input_array_shape is not None:
            return self.example_input_array_shape
        return (1, encoder.in_channels, encoder.in_stack_depth, 224, 224)

    def example_input(self) -> dict:
        return {
            "source": np.zeros(self._example_shape(self.model.source_encoder), np.float32),
            "target": np.zeros(self._example_shape(self.model.target_encoder), np.float32),
        }

    def _projections(self, batch: dict, generator: torch.Generator | None) -> tuple[torch.Tensor, torch.Tensor]:
        (_, s_proj), (_, t_proj) = self.model(batch["source"], batch["target"], generator)
        return s_proj, t_proj

    def training_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        return ntxent_loss(*self._projections(batch, generator), temperature=self.temperature)

    def validation_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """The loss of the deterministic forward (the trainer runs it in eval
        mode: BatchNorm running statistics, no drop path)."""
        return ntxent_loss(*self._projections(batch, None), temperature=self.temperature)

    def predict_step(self, batch: dict) -> dict:
        (s_emb, s_proj), (t_emb, t_proj) = self.model(batch["source"], batch["target"])
        return {"features": s_emb, "projections": s_proj, "target_features": t_emb, "target_projections": t_proj}

    def configure_optimizers(self, total_steps: int):
        from viscy_tpu_torch.training.optimizers import configure_adamw_scheduler

        return configure_adamw_scheduler(self.parameters(), lr=self.lr, schedule=self.schedule,
                                         total_steps=total_steps)
