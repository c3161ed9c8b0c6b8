"""Periodic embedding snapshots during training (counterpart of
``viscy_tpu/training/callbacks/embedding_snapshot.py``): every
``every_n_epochs`` epochs, the encoder's features of the first
``max_batches`` validation batches' anchors go to
``<default_root_dir>/embeddings/epoch_N.npy``, with a PCA pairplot logged
as an image when matplotlib is there."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from viscy_tpu_torch.training.callbacks.base import Callback

_logger = logging.getLogger("viscy_tpu_torch")


def anchor_features(module, anchor: torch.Tensor) -> np.ndarray:
    """The engine's encoder features of ``anchor`` (``module.model(x)[0]``),
    in eval mode without gradient, float32 on the host; the module's mode
    is restored."""
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            return module.model(anchor)[0].float().cpu().numpy()
    finally:
        module.train(was_training)


class EmbeddingSnapshotCallback(Callback):
    """Dump embedding snapshots to ``<root>/embeddings/epoch_N.npy``.

    The anchors are those of the batch the validation step saw (after the
    datamodule's device transform), as Lightning hands the reference's
    callback; the JAX trainer hands its callbacks the batch before that
    transform (``ROADMAP.md`` Queue 3). The pairplot is skipped, with an
    info line, only when matplotlib cannot be imported; any other error is
    raised."""

    def __init__(self, every_n_epochs: int = 10, max_batches: int = 8) -> None:
        self.every_n_epochs = every_n_epochs
        self.max_batches = max_batches
        self._features: list[np.ndarray] = []

    def on_validation_epoch_start(self, trainer, module) -> None:
        self._features.clear()

    def on_validation_batch_end(self, trainer, module, outputs, batch, batch_idx) -> None:
        if trainer.current_epoch % self.every_n_epochs:
            return
        if batch_idx >= self.max_batches or "anchor" not in batch:
            return
        self._features.append(anchor_features(module, batch["anchor"]))

    def on_validation_epoch_end(self, trainer, module, metrics: dict) -> None:
        if trainer.current_epoch % self.every_n_epochs or not self._features:
            return
        feats = np.concatenate(self._features)
        out_dir = Path(trainer.default_root_dir) / "embeddings"
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / f"epoch_{trainer.current_epoch}.npy", feats)
        if len(feats) > 8:
            try:
                import matplotlib  # noqa: F401
            except ImportError:
                _logger.info("embedding pairplot skipped: matplotlib is not installed")
            else:
                from viscy_tpu_torch.training.log_images import pca_pairplot

                trainer.logger.log_image("embeddings/pca", pca_pairplot(feats), trainer.global_step)
        _logger.info(f"Saved embedding snapshot ({feats.shape}) at epoch {trainer.current_epoch}")
