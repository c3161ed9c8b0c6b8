"""Checkpoint and learning-rate-monitor callbacks (counterpart of
``viscy_tpu/training/callbacks/checkpoint.py``).

The trainer owns checkpointing (top-k by a monitored value, plus ``last``)
and logs the learning rate; these callbacks carry the Lightning config
surface (``ModelCheckpoint`` init args of the reference recipes) and
configure the trainer at fit start, so those configs instantiate unchanged.
"""

from __future__ import annotations

from pathlib import Path

from viscy_tpu_torch.training.callbacks.base import Callback


class ModelCheckpoint(Callback):
    """Configure the trainer's checkpointing (reference recipes/trainer/fit.yml).

    The trainer keeps the ``save_top_k`` lowest monitored values, always
    writes ``last`` and names files itself, so ``mode="max"``,
    ``save_last=False`` and a ``filename`` are refused rather than ignored.
    """

    def __init__(
        self,
        monitor: str = "loss/validate",
        every_n_epochs: int = 1,
        save_top_k: int = 5,
        save_last: bool = True,
        dirpath: str | None = None,
        filename: str | None = None,
        mode: str = "min",
        verbose: bool = False,
    ) -> None:
        if mode != "min":
            raise NotImplementedError(f"the trainer keeps the lowest monitored values; mode={mode!r} is not ported")
        if not save_last:
            raise NotImplementedError("the trainer always writes `last`; save_last=False is not ported")
        if filename is not None:
            raise NotImplementedError("checkpoints are named epoch=E-step=S[-loss=L]; filename is not ported")
        self.monitor = monitor
        self.every_n_epochs = every_n_epochs
        self.save_top_k = save_top_k
        self.dirpath = dirpath

    def on_fit_start(self, trainer, module) -> None:
        trainer.checkpoint_monitor = self.monitor
        trainer.checkpoint_top_k = self.save_top_k
        trainer.checkpoint_every_n_epochs = self.every_n_epochs
        if self.dirpath:
            trainer.default_root_dir = Path(self.dirpath).parent


class LearningRateMonitor(Callback):
    """The trainer logs ``lr`` with every logged step; accepted for config parity."""

    def __init__(self, logging_interval: str = "step") -> None:
        self.logging_interval = logging_interval
