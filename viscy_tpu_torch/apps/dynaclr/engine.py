"""DynaCLR contrastive engine (counterpart of
``viscy_tpu/apps/dynaclr/engine.py``; reference
``applications/dynaclr/src/dynaclr/engine.py:33``).

NT-Xent over anchor and positive projections, or the triplet margin loss
with negatives, from a :class:`ContrastiveEncoder`; the predict step
returns ``{"features", "projections"}``.
"""

from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
import torch

from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.contrastive.encoder import ContrastiveEncoder
from viscy_tpu_torch.models.contrastive.loss import NTXentLoss, ntxent_loss, triplet_margin_loss
from viscy_tpu_torch.training.module import TrainModule


class TripletMarginLoss:
    """Euclidean triplet margin loss (torch ``nn.TripletMarginLoss`` analog)."""

    def __init__(self, margin: float = 0.5) -> None:
        self.margin = margin

    def __call__(self, anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor) -> torch.Tensor:
        return triplet_margin_loss(anchor, positive, negative, self.margin)


class ContrastiveModule(TrainModule):
    """Contrastive learning engine over triplet batches (``anchor``,
    ``positive``, and ``negative`` for the triplet loss).

    ``encoder`` is a :class:`ContrastiveEncoder` or its keyword arguments
    (built from a generator seeded with ``seed``, on ``device``, which
    defaults to ``"cuda"`` and raises without a card). ``loss_function``
    defaults to ``TripletMarginLoss(0.5)``; an :class:`NTXentLoss` makes the
    engine forward no negative, and :meth:`on_epoch_start` steps its
    temperature schedule. ``freeze_backbone`` leaves the stem and encoder
    out of the optimizer. The logging knobs are accepted for the reference's
    configs and unused; ``auxiliary_heads`` are not ported and raise."""

    def __init__(
        self,
        encoder: ContrastiveEncoder | dict | None = None,
        loss_function=None,
        lr: float = 1e-3,
        schedule: Literal["WarmupCosine", "Constant"] = "Constant",
        log_batches_per_epoch: int = 8,
        log_samples_per_batch: int = 1,
        log_embeddings_every_n_epochs: int | None = 10,
        pca_color_keys=None,
        log_negative_metrics_every_n_epochs: int = 2,
        example_input_array_shape: Sequence[int] | None = None,
        ckpt_path: str | None = None,
        freeze_backbone: bool = False,
        auxiliary_heads: dict | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        if auxiliary_heads:
            raise NotImplementedError(
                f"auxiliary_heads ({', '.join(auxiliary_heads)}) are not ported to viscy_tpu_torch"
            )
        device = resolve_device(device)
        if not isinstance(encoder, ContrastiveEncoder):
            cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in (encoder or {}).items()}
            encoder = ContrastiveEncoder(**cfg, generator=torch.Generator().manual_seed(seed))
        self.model = encoder.to(device)
        self.loss_function = loss_function if loss_function is not None else TripletMarginLoss(0.5)
        self.lr = lr
        self.schedule = schedule
        if example_input_array_shape is None:
            example_input_array_shape = (1, encoder.in_channels, encoder.in_stack_depth, 256, 256)
        self.example_input_array_shape = tuple(example_input_array_shape)
        self.ckpt_path = ckpt_path
        self.freeze_backbone = freeze_backbone

    @property
    def _is_ntxent(self) -> bool:
        return isinstance(self.loss_function, NTXentLoss)

    def on_epoch_start(self, epoch: int) -> None:
        if hasattr(self.loss_function, "step"):
            self.loss_function.step(epoch)

    def example_input(self) -> dict:
        x = np.zeros(self.example_input_array_shape, np.float32)
        return {"anchor": x, "positive": x.copy(), "negative": x.copy()}

    def _contrastive_loss(self, a_proj, p_proj, n_proj) -> torch.Tensor:
        if self._is_ntxent:
            return ntxent_loss(
                a_proj, p_proj, self.loss_function.temperature, beta=getattr(self.loss_function, "beta", 0.0)
            )
        if n_proj is None:
            raise ValueError("the triplet loss needs negatives")
        return self.loss_function(a_proj, p_proj, n_proj)

    def _views(self, batch: dict, generator: torch.Generator | None) -> tuple:
        """Projections of anchor, positive and (triplet loss only) negative,
        each a forward of its own, in that order: each view normalizes its
        BatchNorms by its own statistics and updates the running ones in
        turn. With ``generator``, every view draws the same drop-path masks
        (JAX hands each forward the step's one dropout key)."""
        state = None if generator is None else generator.get_state()

        def run(x):
            if state is not None:
                generator.set_state(state)
            return self.model(x, generator)[1]

        keys = ("anchor", "positive") if self._is_ntxent else ("anchor", "positive", "negative")
        projs = [run(batch[k]) for k in keys]
        return projs[0], projs[1], projs[2] if len(projs) > 2 else None

    def training_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        return self._contrastive_loss(*self._views(batch, generator))

    def validation_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """The loss of the views' deterministic forwards (the trainer runs it
        in eval mode: BatchNorm running statistics, no drop path)."""
        return self._contrastive_loss(*self._views(batch, None))

    def predict_step(self, batch: dict) -> dict:
        features, projections = self.model(batch["anchor"])
        return {"features": features, "projections": projections}

    def configure_optimizers(self, total_steps: int):
        """AdamW with the engine's schedule (the default warmup), over every
        parameter but the stem's and the encoder's when ``freeze_backbone``
        (no update and no weight decay, as ``optax.set_to_zero``)."""
        from viscy_tpu_torch.training.optimizers import configure_adamw_scheduler

        params = [
            p for name, p in self.model.named_parameters()
            if not (self.freeze_backbone and name.split(".")[0] in ("stem", "encoder"))
        ]
        return configure_adamw_scheduler(params, lr=self.lr, schedule=self.schedule, total_steps=total_steps)
