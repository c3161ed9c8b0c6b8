"""DynaCLR contrastive engine (counterpart of
``viscy_tpu/apps/dynaclr/engine.py``; reference
``applications/dynaclr/src/dynaclr/engine.py:33``).

NT-Xent over anchor and positive projections, or the triplet margin loss
with negatives, from a :class:`ContrastiveEncoder`, plus the weighted
losses of any auxiliary heads on the anchor embedding; the predict step
returns ``{"features", "projections"}``.
"""

from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
import torch
from torch import nn

from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.components.heads import BaseHead
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
    configs and unused.

    ``auxiliary_heads`` maps names to :class:`BaseHead` modules or their
    ``class_path`` / ``init_args`` nodes (built from a generator seeded
    with ``seed + 1``); they live in the model as ``aux_heads.<name>``, so
    the optimizer, checkpoints and ``contrastive_state_dict_from_flax``
    carry them. A head whose ``batch_key`` the batch lacks is skipped; the
    others add ``weight_at(epoch) * loss`` (the epoch of the last
    :meth:`on_epoch_start`) to the training and validation losses."""

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
        device = resolve_device(device)
        if not isinstance(encoder, ContrastiveEncoder):
            cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in (encoder or {}).items()}
            encoder = ContrastiveEncoder(**cfg, generator=torch.Generator().manual_seed(seed))
        heads = _build_heads(auxiliary_heads, torch.Generator().manual_seed(seed + 1))
        if heads:
            encoder.aux_heads = nn.ModuleDict(heads)
        self.model = encoder.to(device)
        self.loss_function = loss_function if loss_function is not None else TripletMarginLoss(0.5)
        self.lr = lr
        self.schedule = schedule
        if example_input_array_shape is None:
            example_input_array_shape = (1, encoder.in_channels, encoder.in_stack_depth, 256, 256)
        self.example_input_array_shape = tuple(example_input_array_shape)
        self.ckpt_path = ckpt_path
        self.freeze_backbone = freeze_backbone

        self._schedule: dict[str, float] = self.schedule_state(0)

    @property
    def _is_ntxent(self) -> bool:
        return isinstance(self.loss_function, NTXentLoss)

    @property
    def auxiliary_heads(self) -> dict[str, BaseHead]:
        return dict(self.model.aux_heads) if hasattr(self.model, "aux_heads") else {}

    def on_epoch_start(self, epoch: int) -> None:
        if hasattr(self.loss_function, "step"):
            self.loss_function.step(epoch)
        self._schedule = self.schedule_state(epoch)

    def schedule_state(self, epoch: int) -> dict[str, float]:
        """The epoch's scalars: the NT-Xent temperature under a cosine
        schedule, and each auxiliary head's loss weight (``aux_weight/<name>``)."""
        sched: dict[str, float] = {}
        lf = self.loss_function
        if self._is_ntxent and getattr(lf, "temperature_schedule", "constant") == "cosine":
            from viscy_tpu_torch.models.contrastive.loss import cosine_anneal

            sched["ntxent_temperature"] = cosine_anneal(lf.temperature_start, lf.temperature_end, epoch,
                                                        lf.temperature_warmup_epochs)
        for name, head in self.auxiliary_heads.items():
            sched[f"aux_weight/{name}"] = head.weight_at(epoch)
        return sched

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

    def _views(self, batch: dict, generator: torch.Generator | None, embedding: bool = False) -> tuple:
        """Projections of anchor, positive and (triplet loss only) negative,
        each a forward of its own, in that order: each view normalizes its
        BatchNorms by its own statistics and updates the running ones in
        turn. With ``generator``, every view draws the same drop-path masks
        (JAX hands each forward the step's one dropout key). With
        ``embedding``, ``(projections, anchor embedding)``."""
        state = None if generator is None else generator.get_state()

        def run(x):
            if state is not None:
                generator.set_state(state)
            return self.model(x, generator)

        keys = ("anchor", "positive") if self._is_ntxent else ("anchor", "positive", "negative")
        outs = [run(batch[k]) for k in keys]
        projs = (outs[0][1], outs[1][1], outs[2][1] if len(outs) > 2 else None)
        return (projs, outs[0][0]) if embedding else projs

    def _aux_loss(self, a_emb: torch.Tensor, batch: dict):
        """The weighted sum of the heads' losses on the anchor embedding
        (reference ``engine.py:250``), or 0 when no head has its batch key."""
        total = 0.0
        for name, head in self.auxiliary_heads.items():
            y = batch.get(head.batch_key)
            if y is None:
                continue
            loss, _ = head(a_emb, y)
            total = total + self._schedule.get(f"aux_weight/{name}", head.weight_at(0)) * loss
        return total

    def _loss(self, batch: dict, generator: torch.Generator | None) -> torch.Tensor:
        projs, a_emb = self._views(batch, generator, embedding=True)
        loss = self._contrastive_loss(*projs)
        return loss + self._aux_loss(a_emb, batch) if self.auxiliary_heads else loss

    def training_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        return self._loss(batch, generator)

    def validation_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """The loss of the views' deterministic forwards (the trainer runs it
        in eval mode: BatchNorm running statistics, no drop path)."""
        return self._loss(batch, None)

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


def _build_heads(spec: dict | None, generator: torch.Generator) -> dict[str, BaseHead]:
    """``auxiliary_heads`` as modules: each value a :class:`BaseHead` or a
    ``{"class_path": ..., "init_args": {...}}`` node."""
    from viscy_tpu_torch.training.instantiate import resolve_class

    heads: dict[str, BaseHead] = {}
    for name, head in (spec or {}).items():
        if isinstance(head, dict):
            if "class_path" not in head:
                raise ValueError(f"auxiliary_heads[{name!r}] needs a class_path (got keys {sorted(head)})")
            head = resolve_class(head["class_path"])(**(head.get("init_args") or {}), generator=generator)
        if not isinstance(head, BaseHead):
            raise TypeError(f"auxiliary_heads[{name!r}] is a {type(head).__name__}, not a head")
        heads[name] = head
    return heads
