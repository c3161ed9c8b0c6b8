"""Dynacell benchmark engines (counterpart of
``viscy_tpu/apps/dynacell/engine.py``; reference
``applications/dynacell/src/dynacell/engine.py``).

- ``DynacellUNet``: supervised regression over the cytoland registry plus
  ``"UNetViT3D"``.
- ``DynacellFlowMatching``: CELLDiff velocity training and ODE sampling
  from noise.

``DynacellGAN`` waits for the GAN models (``models/gan``), which are not
ported.
"""

from __future__ import annotations

import logging
from typing import Literal, Sequence

import numpy as np
import torch

from viscy_tpu_torch.apps.cytoland.engine import _UNET_ARCHITECTURE, VSUNet
from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.celldiff import CELLDiffNet, UNetViT3D, create_transport, euler_sampler, heun_sampler
from viscy_tpu_torch.training.module import TrainModule

_logger = logging.getLogger("viscy_tpu_torch")


class DynacellUNet(VSUNet):
    """Supervised benchmark engine: ``VSUNet`` whose registry also holds
    ``"UNetViT3D"`` (the default architecture)."""

    architectures = {**_UNET_ARCHITECTURE, "UNetViT3D": UNetViT3D}

    def __init__(self, architecture: str = "UNetViT3D", model_config: dict | None = None, **kwargs) -> None:
        super().__init__(architecture, model_config, **kwargs)


class DynacellFlowMatching(TrainModule):
    """Flow-matching virtual staining (CELLDiff).

    ``net_config`` (or its local alias ``model_config``) builds the
    :class:`CELLDiffNet`, with weights drawn from a generator seeded with
    ``seed``; ``transport_config`` the transport (``path_type``,
    ``prediction``, ``loss_weight``, ``train_eps``, ``sample_eps``,
    ``t_sampler``; linear velocity matching by default). Training and
    validation draw the noise ``x0`` and then the times ``t`` from the
    trainer's generator. ``predict_step`` integrates the velocity of the
    source-conditioned network from noise in ``num_generate_steps`` (else
    ``num_sampling_steps``) Euler or Heun steps; its noise comes from a
    generator seeded with 0 on every call, as the JAX engine draws it from
    ``PRNGKey(0)``, so every call with the same shape starts from the same
    noise. ``device`` defaults to ``"cuda"``.

    Kept as the JAX engine keeps them, without effect on any step:
    ``warmup_steps`` (the optimizer takes the schedule's default warmup, 1 %
    of the steps, as the JAX engine's does), ``predict_method`` and
    ``predict_overlap`` (the predict step samples the window it is given),
    the logging knobs and ``compute_validation_loss``; ``ckpt_path`` loads
    nothing (resume with the trainer's ``ckpt_path``).
    """

    def __init__(
        self,
        model_config: dict | None = None,
        net_config: dict | None = None,
        transport_config: dict | None = None,
        lr: float = 1e-4,
        schedule: Literal["WarmupCosine", "Constant"] = "Constant",
        num_sampling_steps: int = 50,
        num_generate_steps: int | None = None,
        sampler: Literal["euler", "heun"] = "euler",
        example_input_yx_shape: Sequence[int] = (64, 64),
        warmup_steps: int = 3,
        warmup_multiplier: float = 1e-3,
        log_batches_per_epoch: int = 8,
        log_samples_per_batch: int = 1,
        num_log_steps: int = 10,
        compute_validation_loss: bool = False,
        predict_method: Literal["denoise", "generate", "sliding_window", "iterative"] = "generate",
        predict_overlap: int | tuple[int, int, int] = 256,
        ckpt_path: str | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        if sampler not in ("euler", "heun"):
            raise ValueError(f"sampler must be 'euler' or 'heun', got {sampler!r}")
        device = resolve_device(device)
        model_config = {k: tuple(v) if isinstance(v, list) else v
                        for k, v in dict(net_config or model_config or {}).items()}
        self.model_config = model_config
        self.model = CELLDiffNet(**model_config, generator=torch.Generator().manual_seed(seed)).to(device)
        tc = dict(transport_config or {})
        self.transport = create_transport(
            path_type=tc.get("path_type", "Linear"),
            prediction=tc.get("prediction", "velocity"),
            loss_weight=tc.get("loss_weight"),
            train_eps=tc.get("train_eps"),
            sample_eps=tc.get("sample_eps"),
            t_sampler=tc.get("t_sampler", "uniform"),
        )
        self.lr = lr
        self.schedule = schedule
        self.num_sampling_steps = int(num_generate_steps or num_sampling_steps)
        self.sampler = sampler
        self.example_input_yx_shape = tuple(example_input_yx_shape)
        self.warmup_steps = warmup_steps
        self.warmup_multiplier = warmup_multiplier
        self.compute_validation_loss = compute_validation_loss
        self.predict_method = predict_method
        self.predict_overlap = predict_overlap
        self.ckpt_path = ckpt_path
        if ckpt_path is not None:
            _logger.warning("model ckpt_path %s loads nothing; pass the trainer's ckpt_path to resume", ckpt_path)

    def example_input(self) -> dict:
        """Zero ``source`` (1, cond_channels, 4, *yx) and ``target`` (1,
        out_channels, 4, *yx) arrays, as the JAX engine's."""
        yx = self.example_input_yx_shape
        return {
            "source": np.zeros((1, self.model.cond_channels, 4, *yx), np.float32),
            "target": np.zeros((1, self.model.out_channels, 4, *yx), np.float32),
        }

    def _loss(self, batch: dict, generator, t, x0) -> torch.Tensor:
        cond = batch["source"]
        return self.transport.training_loss(lambda xt, tt: self.model(xt, cond, tt), batch["target"],
                                            generator, t, x0)

    def training_loss(self, batch: dict, generator: torch.Generator | None = None, t: torch.Tensor | None = None,
                      x0: torch.Tensor | None = None) -> torch.Tensor:
        """The flow-matching loss of the velocity at ``x_t`` against the
        path's target, the noise ``x0`` and the times ``t`` drawn from
        ``generator`` unless given."""
        return self._loss(batch, generator, t, x0)

    def validation_loss(self, batch: dict, generator: torch.Generator | None = None, t: torch.Tensor | None = None,
                        x0: torch.Tensor | None = None) -> torch.Tensor:
        """As :meth:`training_loss` (the trainer runs it in eval mode)."""
        return self._loss(batch, generator, t, x0)

    def predict_step(self, batch: dict, x0: torch.Tensor | None = None) -> torch.Tensor:
        """Sample the target of ``batch["source"]`` from the noise ``x0``
        (``(B, out_channels, *spatial)``; default: drawn from a generator
        seeded with 0 on the source's device)."""
        cond = batch["source"]
        if x0 is None:
            shape = (cond.shape[0], self.model.out_channels, *cond.shape[2:])
            g = torch.Generator(device=cond.device).manual_seed(0)
            x0 = torch.randn(shape, generator=g, device=cond.device)
        sample = euler_sampler if self.sampler == "euler" else heun_sampler
        return sample(lambda x, t: self.model(x, cond, t), x0, self.num_sampling_steps)

    def configure_optimizers(self, total_steps: int):
        """AdamW with the engine's schedule (its default warmup)."""
        from viscy_tpu_torch.training.optimizers import configure_adamw_scheduler

        return configure_adamw_scheduler(self.parameters(), lr=self.lr, schedule=self.schedule,
                                         total_steps=total_steps)
