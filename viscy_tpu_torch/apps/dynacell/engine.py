"""Dynacell benchmark engines (counterpart of
``viscy_tpu/apps/dynacell/engine.py``; reference
``applications/dynacell/src/dynacell/engine.py``).

- ``DynacellUNet``: supervised regression over the cytoland registry plus
  ``"UNetViT3D"``.
- ``DynacellFlowMatching``: CELLDiff velocity training and ODE sampling
  from noise.
- ``DynacellGAN``: a generator and a multiscale spectral-norm PatchGAN
  trained together by one backward of ``g_loss + d_loss``, the JAX
  formulation's stop-gradients made by detached copies.
"""

from __future__ import annotations

import logging
from typing import Literal, Sequence

import numpy as np
import torch
from torch.func import functional_call

from viscy_tpu_torch.apps.cytoland.engine import _UNET_ARCHITECTURE, VSUNet
from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.celldiff import CELLDiffNet, UNetViT3D, create_transport, euler_sampler, heun_sampler
from viscy_tpu_torch.models.gan import (
    MultiScalePatchGAN3D,
    feature_matching_loss,
    gan_loss_d,
    gan_loss_g,
    lecam_penalty,
    mean_logit,
)
from viscy_tpu_torch.parallel.distributed import process_count
from viscy_tpu_torch.parallel.mesh import data_parallel, global_sum
from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss
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


def global_mean_logit(logits) -> torch.Tensor:
    """:func:`mean_logit` over the global batch (differentiable): the local
    logits' sum and count summed over the processes, so every rank gets the
    one-process value of the whole batch; ``mean_logit`` in one process."""
    if not data_parallel():
        return mean_logit(logits)
    flat = torch.cat([x.reshape(-1).float() for x in (logits if isinstance(logits, (list, tuple)) else [logits])])
    sums = global_sum(torch.stack([flat.sum(), flat.new_tensor(float(flat.numel()))]))
    return sums[0] / sums[1]


class DynacellGAN(TrainModule):
    """Adversarial virtual staining: a generator and a multiscale PatchGAN
    (reference ``dynacell/engine.py:692``; the JAX engine's formulation).

    The generator is ``generator`` (an engine, e.g. a ``VSUNet``, whose
    ``model`` is used), ``"UNetViT3D"`` built from ``generator_config``, or
    the ``VSUNet`` of ``architecture`` (default ``"fcmae"``, built with
    ``pretraining=False``) from ``generator_config``. The discriminator is
    :class:`MultiScalePatchGAN3D` of ``discriminator_config``; its input is
    the source and the prediction (or target) stacked on the channel axis,
    so its ``in_channels`` is the generator's in + out channels, whatever
    the config says (the flax model infers it). Weights come from
    generators seeded with ``seed`` (``seed + 1`` for the discriminator).

    One step (:meth:`training_loss`) returns ``g_loss + d_loss``, whose one
    backward gives the generator the gradients of ``g_loss`` alone and the
    discriminator those of ``d_loss`` alone: the two discriminator calls of
    ``g_loss`` run on detached discriminator parameters, the two of
    ``d_loss`` on the detached prediction. ``g_loss = lambda_adv * adv +
    lambda_fm * feature matching + lambda_recon * L1``; ``d_loss`` is the
    ``gan_mode`` loss, plus every ``r1_every`` steps (counting
    ``d_step``) the R1 / R2 penalties ``gamma / 2 * penalty * r1_every``,
    plus ``lecam_gamma`` times LeCam against EMA logit means. The real
    batch's discriminator call advances the spectral-norm ``u`` once a
    step, stored when the step's losses are formed; every other call of
    the step starts from the step's old ``u``, as in JAX. With ``ema_kimg``
    an EMA of the generator's parameters, ``beta = 0.5 ** (B / (1000 *
    ema_kimg))``, is taken from the parameters BEFORE the step's update, as
    the JAX loss takes it; ``predict_step`` uses it when
    ``use_ema_at_predict``. The step's loss terms are in ``last_metrics``.
    The R1 / R2 penalties are computed on the steps that apply them only
    (JAX computes them every step and multiplies by 0 between).

    In a job of several processes each rank steps on its rows and the
    trainer averages the gradients; the terms follow the JAX step over the
    global batch: the LeCam EMAs take the global mean logits (the same on
    every rank), R1 / R2 the gradient of the global mean logit and the
    global sample count, and the EMA generator's ``B`` is the global batch.

    ``configure_optimizers``: one AdamW (beta1 0.5) with the generator's
    and the discriminator's parameter groups at ``lr_g`` and ``lr_d``
    (``lr`` sets both) under one schedule, so the trainer's clipping and
    accumulation act on both together, as the JAX ``multi_transform``.
    Checkpoints carry the discriminator (``u`` and ``sigma`` included), the
    EMA generator and ``gan_state`` (:meth:`checkpoint_state`). The
    logging and prediction-method knobs are kept without effect, as in
    JAX; ``ckpt_path`` loads nothing (resume with the trainer's)."""

    def __init__(
        self,
        architecture: str | None = None,
        generator: TrainModule | None = None,
        generator_config: dict | None = None,
        discriminator_config: dict | None = None,
        gan_mode: Literal["lsgan", "hinge", "nonsat", "rpgan"] | None = None,
        loss_type: Literal["lsgan", "nonsat", "rpgan"] | None = None,
        lambda_recon: float | None = None,
        lambda_l1: float = 100.0,
        lambda_adv: float = 1.0,
        lambda_fm: float = 10.0,
        r1_gamma: float = 0.0,
        r2_gamma: float = 0.0,
        r1_every: int = 16,
        ema_kimg: float | None = None,
        lecam_gamma: float = 0.0,
        lecam_decay: float = 0.9,
        use_ema_at_predict: bool = True,
        lr: float | None = None,
        lr_g: float = 3e-4,
        lr_d: float = 3e-4,
        schedule: Literal["WarmupCosine", "Constant"] = "Constant",
        warmup_steps: int = 0,
        warmup_multiplier: float = 1e-3,
        log_batches_per_epoch: int = 8,
        log_samples_per_batch: int = 1,
        example_input_yx_shape: Sequence[int] = (64, 64),
        predict_method: Literal["full_image"] = "full_image",
        predict_overlap: Sequence[int] = (4, 256, 256),
        ckpt_path: str | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in (generator_config or {}).items()}
        self._generator_example = None
        if generator is not None:
            self.model = generator.model
            self._generator_example = generator.example_input
        elif architecture == "UNetViT3D":
            self.model = UNetViT3D(**cfg, generator=torch.Generator().manual_seed(seed))
        else:
            arch = architecture or "fcmae"
            gen = VSUNet(arch, dict(cfg, pretraining=False) if arch == "fcmae" else cfg,
                         loss_function=MixedLoss(l1_alpha=1.0, ms_dssim_alpha=0.0), seed=seed, device=device)
            self.model = gen.model
            self._generator_example = gen.example_input
        self.model.to(device)
        d_cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in (discriminator_config or {}).items()}
        d_cfg["in_channels"] = self.model.in_channels + self.model.out_channels
        self.discriminator = MultiScalePatchGAN3D(**d_cfg, generator=torch.Generator().manual_seed(seed + 1)).to(device)
        self.gan_mode = loss_type or gan_mode or "lsgan"
        if self.gan_mode not in ("lsgan", "hinge", "nonsat", "rpgan"):
            raise ValueError(f"gan_mode must be lsgan, hinge, nonsat or rpgan, got {self.gan_mode!r}")
        self.lambda_recon = lambda_l1 if lambda_recon is None else lambda_recon
        self.lambda_adv, self.lambda_fm = lambda_adv, lambda_fm
        self.r1_gamma, self.r2_gamma = r1_gamma, r2_gamma
        self.r1_every = max(int(r1_every), 1)
        self.ema_kimg = ema_kimg
        self.lecam_gamma, self.lecam_decay = lecam_gamma, lecam_decay
        self.use_ema_at_predict = use_ema_at_predict
        self.lr_g = lr if lr is not None else lr_g
        self.lr_d = lr if lr is not None else lr_d
        self.schedule = schedule
        self.warmup_steps = warmup_steps
        self.warmup_multiplier = warmup_multiplier
        self.example_input_yx_shape = tuple(example_input_yx_shape)
        self.predict_method = predict_method
        self.predict_overlap = tuple(predict_overlap)
        self.ckpt_path = ckpt_path
        self.d_step = 0
        self.lecam_real = torch.zeros((), device=device)
        self.lecam_fake = torch.zeros((), device=device)
        self.ema_generator: dict[str, torch.Tensor] | None = None
        if ema_kimg is not None:
            self.ema_generator = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.last_metrics: dict[str, torch.Tensor] = {}

    def example_input(self) -> dict:
        """The generator engine's example input, else zero (1, C, 4,
        *example_input_yx_shape) source and target arrays."""
        if self._generator_example is not None:
            return self._generator_example()
        yx = self.example_input_yx_shape
        return {"source": np.zeros((1, self.model.in_channels, 4, *yx), np.float32),
                "target": np.zeros((1, self.model.out_channels, 4, *yx), np.float32)}

    def _d(self, source, x, params=None, update_stats: bool = False):
        """The discriminator's per-scale ``(logits, features)`` on ``source``
        and ``x`` stacked on channels; ``params`` replaces its parameters
        (the detached ones of the generator's loss)."""
        inp = torch.cat([source, x], dim=1)
        if params is None:
            return self.discriminator(inp, return_features=True, update_stats=update_stats)
        return functional_call(self.discriminator, params, (inp,), {"return_features": True})

    def _penalty(self, source, x) -> torch.Tensor:
        """``sum((d mean_logit / d x)^2) / B`` over the global batch,
        differentiable in the discriminator (a double backward). Under
        several processes every rank seeds the same global mean logit, so the
        backward of its global sum hands each rank ``world`` times its rows'
        gradient: that is divided out before the square, and the squares
        and the sample count are summed over the processes."""
        x = x.detach().float().requires_grad_(True)
        (grad,) = torch.autograd.grad(global_mean_logit(self._d(source, x)[0]), x, create_graph=True)
        if not data_parallel():
            return (grad * grad).sum() / x.shape[0]
        grad = grad / process_count()
        sums = global_sum(torch.stack([(grad * grad).sum(), grad.new_tensor(float(x.shape[0]))]))
        return sums[0] / sums[1]

    def adversarial_losses(self, batch: dict, generator: torch.Generator | None = None):
        """``(g_loss, d_loss)`` of one batch, and the step's state updates
        (see the class docstring); ``generator`` draws the generator
        network's random masks. In a job of several processes the terms
        that couple samples other than by a mean (LeCam's EMAs, R1 / R2, the
        EMA's ``B``) are those of the global batch."""
        world = process_count()
        source, target = batch["source"], batch["target"]
        pred = self.model(source, generator=generator)
        frozen = {n: p.detach() for n, p in self.discriminator.named_parameters()}
        fake_logits_g, fake_feats_g = self._d(source, pred, frozen)
        real_logits_g, real_feats_g = self._d(source, target, frozen)
        g_adv = gan_loss_g(fake_logits_g, self.gan_mode, real_logits=real_logits_g)
        g_fm = feature_matching_loss([[f.detach() for f in s] for s in real_feats_g], fake_feats_g)
        g_recon = (pred.float() - target.float()).abs().mean()
        g_loss = self.lambda_adv * g_adv + self.lambda_fm * g_fm + self.lambda_recon * g_recon

        pred_d = pred.detach()
        fake_logits_d, _ = self._d(source, pred_d)
        real_logits_d, _ = self._d(source, target, update_stats=True)
        d_loss = gan_loss_d(real_logits_d, fake_logits_d, self.gan_mode)
        metrics = {"loss/g_adv": g_adv, "loss/g_fm": g_fm, "loss/g_recon": g_recon, "loss/d": d_loss}
        if (self.r1_gamma > 0 or self.r2_gamma > 0) and self.d_step % self.r1_every == 0:
            if self.r1_gamma > 0:
                r1 = self._penalty(source, target)
                d_loss = d_loss + (self.r1_gamma / 2) * r1 * self.r1_every
                metrics["loss/r1"] = r1
            if self.r2_gamma > 0:
                r2 = self._penalty(source, pred_d)
                d_loss = d_loss + (self.r2_gamma / 2) * r2 * self.r1_every
                metrics["loss/r2"] = r2
        if self.lecam_gamma > 0:
            keep = self.lecam_decay
            with torch.no_grad():
                ema_r = self.lecam_real * keep + global_mean_logit(real_logits_d) * (1 - keep)
                ema_f = self.lecam_fake * keep + global_mean_logit(fake_logits_d) * (1 - keep)
            d_loss = d_loss + self.lecam_gamma * lecam_penalty(real_logits_d, fake_logits_d, ema_r, ema_f)
            self.lecam_real, self.lecam_fake = ema_r, ema_f
        self.d_step += 1
        if self.ema_generator is not None:
            beta = 0.5 ** (source.shape[0] * world / max(self.ema_kimg * 1000.0, 1e-8))
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    e = self.ema_generator[name]
                    e.copy_(e * beta + p.detach() * (1.0 - beta))
        self.discriminator.commit_stats()
        metrics["loss/d_total"] = d_loss
        self.last_metrics = {k: v.detach() for k, v in metrics.items()}
        return g_loss, d_loss

    def training_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """``g_loss + d_loss`` of :meth:`adversarial_losses`."""
        g_loss, d_loss = self.adversarial_losses(batch, generator)
        return g_loss + d_loss

    def validation_loss(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """The generator's L1 against the target (float32)."""
        return (self.model(batch["source"]).float() - batch["target"].float()).abs().mean()

    def predict_step(self, batch: dict) -> torch.Tensor:
        """The generator on ``batch["source"]``, with the EMA parameters when
        ``use_ema_at_predict`` and an EMA is kept."""
        if self.use_ema_at_predict and self.ema_generator is not None:
            return functional_call(self.model, self.ema_generator, (batch["source"],))
        return self.model(batch["source"])

    def checkpoint_state(self) -> dict:
        state = {"discriminator": self.discriminator.state_dict(),
                 "gan_state": {"d_step": self.d_step, "lecam_real": self.lecam_real, "lecam_fake": self.lecam_fake}}
        if self.ema_generator is not None:
            state["ema_generator"] = self.ema_generator
        return state

    def load_checkpoint_state(self, state: dict) -> None:
        """Restore the discriminator (``u`` and ``sigma`` included),
        ``gan_state`` and, where kept, the EMA generator (from a checkpoint,
        or from ``viscy_tpu_torch.training.convert.gan_state_dict_from_flax``)."""
        dev = next(self.model.parameters()).device
        self.discriminator.load_state_dict(state["discriminator"], strict=True)
        gs = state.get("gan_state", {})
        self.d_step = int(gs.get("d_step", 0))
        self.lecam_real = torch.as_tensor(gs.get("lecam_real", 0.0), dtype=torch.float32).to(dev)
        self.lecam_fake = torch.as_tensor(gs.get("lecam_fake", 0.0), dtype=torch.float32).to(dev)
        if self.ema_generator is not None:
            ema = state.get("ema_generator")
            if ema is None:
                _logger.warning("the checkpoint keeps no EMA generator: it restarts from the loaded weights")
                ema = dict(self.model.named_parameters())
            # a flax tree lacks the branches its model never ran (the FCMAE's
            # 2-D stem): those keep the live weights, as load_flax_params does
            self.ema_generator = {n: ema.get(n, p).detach().to(dev, torch.float32).clone()
                                  for n, p in self.model.named_parameters()}

    def configure_optimizers(self, total_steps: int):
        """One AdamW (beta1 0.5) over the generator's (``lr_g``) and the
        discriminator's (``lr_d``) parameters, both under the engine's
        schedule (``warmup_steps`` as given, 0 by default, as in JAX)."""
        from viscy_tpu_torch.training.optimizers import configure_adamw_scheduler

        groups = [{"params": list(self.model.parameters()), "lr": self.lr_g},
                  {"params": list(self.discriminator.parameters()), "lr": self.lr_d}]
        return configure_adamw_scheduler(groups, lr=self.lr_g, schedule=self.schedule, total_steps=total_steps,
                                         warmup_steps=self.warmup_steps, warmup_multiplier=self.warmup_multiplier,
                                         b1=0.5)
