"""Flow-matching transport: paths, training losses and the samplers the
dynacell engine uses (counterpart of
``viscy_tpu/models/celldiff/transport.py``; reference
``celldiff/modules/transport/transport.py``).

:class:`Transport` holds the path plan (linear / GVP / VP), what the model
predicts (velocity / noise / score / denoised), the loss weighting and the
interval handling; ``euler_sampler`` / ``heun_sampler`` / ``sde_sampler``
integrate a velocity field from noise (t = 0) to data (t = 1) in fixed
steps. Random draws come from an explicit ``torch.Generator``, or are
passed in as tensors (``t`` and ``x0`` of a training step, the SDE's
noise), so a test can hand in the JAX package's draws. The JAX package's
``Sampler`` class (ODE methods, SDE, likelihood) is not ported: no entry
point uses it.
"""

from __future__ import annotations

import math
from typing import Callable, Literal

import numpy as np
import torch

from viscy_tpu_torch.models.celldiff.paths import GVPCPlan, ICPlan, VPCPlan, expand_t_like_x

ModelType = Literal["velocity", "noise", "score", "denoised"]
PathType = Literal["linear", "gvp", "vp"]
WeightType = Literal["none", "velocity", "likelihood"]
VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_PATHS = {"linear": ICPlan, "gvp": GVPCPlan, "vp": VPCPlan}

__all__ = ["Transport", "create_transport", "euler_sampler", "heun_sampler", "sde_sampler"]


def _mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the batch, in float32."""
    return x.float().mean(dim=tuple(range(1, x.ndim)))


class Transport:
    """Flow-matching transport (the JAX package's arguments: ``prediction``,
    ``t_sampler`` uniform or logit-normal, ``path_type``, ``loss_type``,
    ``train_eps`` and ``sample_eps``)."""

    def __init__(
        self,
        prediction: ModelType = "velocity",
        t_sampler: Literal["uniform", "logit-normal"] = "uniform",
        path_type: PathType = "linear",
        loss_type: WeightType = "none",
        train_eps: float = 0.0,
        sample_eps: float = 0.0,
        **path_kwargs,
    ) -> None:
        if prediction not in ("velocity", "noise", "score", "denoised"):
            raise ValueError(f"unknown prediction type {prediction!r}")
        self.prediction = prediction
        self.t_sampler = t_sampler
        self.path_type = path_type
        self.loss_type = loss_type
        self.path_sampler = _PATHS[path_type](**path_kwargs)
        self.train_eps = train_eps
        self.sample_eps = sample_eps

    def check_interval(
        self,
        train_eps: float,
        sample_eps: float,
        *,
        diffusion_form: str = "SBDM",
        sde: bool = False,
        reverse: bool = False,
        is_eval: bool = False,
        last_step_size: float = 0.0,
    ) -> tuple[float, float]:
        """The integration interval [t0, t1] for the path and model type."""
        t0, t1 = 0.0, 1.0
        eps = train_eps if not is_eval else sample_eps
        if isinstance(self.path_sampler, VPCPlan):
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        elif isinstance(self.path_sampler, (ICPlan, GVPCPlan)) and (self.prediction != "velocity" or sde):
            t0 = eps if (diffusion_form == "SBDM" and sde) or self.prediction != "velocity" else 0.0
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        if reverse:
            t0, t1 = 1 - t1, 1 - t0
        return t0, t1

    def sample_t(self, batch: int, generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
        """``batch`` training times in the train interval, uniform or
        logit-normal, drawn from ``generator``."""
        t0, t1 = self.check_interval(self.train_eps, self.sample_eps)
        if self.t_sampler == "logit-normal":
            u = torch.sigmoid(torch.randn(batch, generator=generator, device=device))
        else:
            u = torch.rand(batch, generator=generator, device=device)
        return u * (t1 - t0) + t0

    def sample(self, x1: torch.Tensor, generator: torch.Generator | None = None, t: torch.Tensor | None = None,
               x0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(t, x0, x1)`` for a training step: the noise ``x0`` and then
        ``t`` drawn from ``generator`` (on ``x1``'s device), unless given."""
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
        if t is None:
            t = self.sample_t(x1.shape[0], generator, x1.device)
        return t, x0, x1

    def interpolate(self, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(x_t, target)`` for the model type."""
        _, xt, ut = self.path_sampler.plan(t, x0, x1)
        if self.prediction == "velocity":
            target = ut
        elif self.prediction == "noise":
            target = x0
        elif self.prediction == "denoised":
            target = x1
        else:  # the score target -x0 / sigma_t
            sigma_t, _ = self.path_sampler.compute_sigma_t(expand_t_like_x(t, x1))
            target = -x0 / torch.clamp_min(sigma_t, 1e-7)
        return xt, target

    def training_losses(self, model_output: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, xt: torch.Tensor,
                        ut: torch.Tensor, t: torch.Tensor) -> dict[str, torch.Tensor]:
        """The weighted per-sample losses (``"loss"``, float32) and ``"pred"``."""
        terms = {"pred": model_output}
        if self.prediction == "velocity":
            terms["loss"] = _mean_flat((model_output - ut) ** 2)
        elif self.prediction == "denoised":
            terms["loss"] = _mean_flat((model_output - x1) ** 2)
        else:
            _, drift_var = self.path_sampler.compute_drift(xt, t)
            sigma_t, _ = self.path_sampler.compute_sigma_t(expand_t_like_x(t, xt))
            if self.loss_type == "velocity":
                weight = (drift_var / sigma_t) ** 2
            elif self.loss_type == "likelihood":
                weight = drift_var / (sigma_t**2)
            elif self.loss_type == "none":
                weight = 1.0
            else:
                raise NotImplementedError(f"Loss type {self.loss_type} not implemented")
            if self.prediction == "noise":
                terms["loss"] = _mean_flat(weight * (model_output - x0) ** 2)
            else:
                terms["loss"] = _mean_flat(weight * (model_output * sigma_t + x0) ** 2)
        return terms

    def training_loss(self, model_fn: VelocityFn, x1: torch.Tensor, generator: torch.Generator | None = None,
                      t: torch.Tensor | None = None, x0: torch.Tensor | None = None) -> torch.Tensor:
        """The scalar flow-matching loss of ``model_fn(x_t, t)`` on ``x1``,
        its draws from ``generator`` unless ``t`` / ``x0`` are given."""
        t, x0, x1 = self.sample(x1, generator, t, x0)
        _, xt, ut = self.path_sampler.plan(t, x0, x1)
        pred = model_fn(xt, t)
        return self.training_losses(pred.float(), x0, x1, xt, ut, t)["loss"].mean()

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """Standard-normal log probability per sample."""
        n_dims = math.prod(z.shape[1:])
        flat = z.reshape(z.shape[0], -1).float()
        return -n_dims / 2.0 * math.log(2 * math.pi) - (flat**2).sum(dim=1) / 2.0

    def get_drift(self) -> Callable:
        """The ODE drift ``f(x, t, model_fn) -> dx/dt`` for the model type."""
        ps = self.path_sampler

        def velocity_ode(x, t, model_fn):
            return model_fn(x, t)

        def score_ode(x, t, model_fn):
            drift_mean, drift_var = ps.compute_drift(x, t)
            return -drift_mean + drift_var * model_fn(x, t)

        def noise_ode(x, t, model_fn):
            drift_mean, drift_var = ps.compute_drift(x, t)
            sigma_t, _ = ps.compute_sigma_t(expand_t_like_x(t, x))
            return -drift_mean + drift_var * (model_fn(x, t) / -sigma_t)

        def denoised_ode(x, t, model_fn):
            drift_mean, drift_var = ps.compute_drift(x, t)
            return -drift_mean + drift_var * ps.get_score_from_denoised(model_fn(x, t), x, t)

        return {"velocity": velocity_ode, "score": score_ode, "noise": noise_ode,
                "denoised": denoised_ode}[self.prediction]

    def get_score(self) -> Callable:
        """The score ``s(x, t, model_fn)`` for the model type."""
        ps = self.path_sampler

        def _noise(x, t, model_fn):
            return model_fn(x, t) / -ps.compute_sigma_t(expand_t_like_x(t, x))[0]

        def _score(x, t, model_fn):
            return model_fn(x, t)

        def _velocity(x, t, model_fn):
            return ps.get_score_from_velocity(model_fn(x, t), x, t)

        def _denoised(x, t, model_fn):
            return ps.get_score_from_denoised(model_fn(x, t), x, t)

        return {"noise": _noise, "score": _score, "velocity": _velocity, "denoised": _denoised}[self.prediction]


def create_transport(
    path_type: str = "Linear",
    prediction: str = "velocity",
    loss_weight: str | None = None,
    train_eps: float | None = None,
    sample_eps: float | None = None,
    t_sampler: str = "uniform",
) -> Transport:
    """A :class:`Transport` from the reference's vocabulary (``Linear`` /
    ``GVP`` / ``VP``; loss weight None / velocity / likelihood), with its
    epsilon defaults: 1e-5 / 1e-3 on the VP path, 1e-3 / 1e-3 for a model
    that does not predict velocity, else 0."""
    path_map = {"Linear": "linear", "GVP": "gvp", "VP": "vp"}
    if path_type not in path_map:
        raise ValueError(f"Unknown path_type {path_type!r}, expected one of {set(path_map)}")
    if prediction not in ("velocity", "noise", "score", "denoised"):
        raise ValueError(f"Unknown prediction {prediction!r}")
    loss_map: dict = {None: "none", "velocity": "velocity", "likelihood": "likelihood"}
    if loss_weight not in loss_map:
        raise ValueError(f"Unknown loss_weight {loss_weight!r}, expected one of {set(loss_map)}")
    resolved = path_map[path_type]
    if resolved == "vp":
        defaults = (1e-5, 1e-3)
    elif prediction != "velocity":
        defaults = (1e-3, 1e-3)
    else:  # velocity on the GVP or linear path is stable everywhere
        defaults = (0.0, 0.0)
    return Transport(
        prediction=prediction,
        t_sampler=t_sampler,
        path_type=resolved,
        loss_type=loss_map[loss_weight],
        train_eps=defaults[0] if train_eps is None else train_eps,
        sample_eps=defaults[1] if sample_eps is None else sample_eps,
    )


def _t(x: torch.Tensor, i: float, dt: float) -> torch.Tensor:
    """The (B,) float32 time ``i * dt``, the product taken in float32 as JAX
    takes it."""
    return torch.full((x.shape[0],), float(np.float32(i) * np.float32(dt)), device=x.device)


def euler_sampler(velocity_fn: VelocityFn, x0: torch.Tensor, num_steps: int = 50) -> torch.Tensor:
    """Deterministic Euler integration of ``velocity_fn`` from ``x0`` (t = 0)
    to t = 1 in ``num_steps`` steps."""
    dt = 1.0 / num_steps
    x = x0
    for i in range(num_steps):
        x = x + dt * velocity_fn(x, _t(x, i, dt))
    return x


def heun_sampler(velocity_fn: VelocityFn, x0: torch.Tensor, num_steps: int = 25) -> torch.Tensor:
    """Heun (second-order) integration from ``x0`` (t = 0) to t = 1."""
    dt = 1.0 / num_steps
    x = x0
    for i in range(num_steps):
        v1 = velocity_fn(x, _t(x, i, dt))
        v2 = velocity_fn(x + dt * v1, _t(x, i + 1, dt))
        x = x + dt * 0.5 * (v1 + v2)
    return x


def sde_sampler(
    velocity_fn: VelocityFn,
    x0: torch.Tensor,
    generator: torch.Generator | None = None,
    num_steps: int = 50,
    diffusion: float = 0.5,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Euler-Maruyama on the linear path with the score from the velocity:
    ``score = (t v - x) / max(1 - t, 1e-3)``, drift ``v + 0.5 w score`` with
    ``w = diffusion (1 - t)``. Step ``i``'s noise is ``noise[i]`` when given
    (``(num_steps, *x0.shape)``), else drawn from ``generator``."""
    dt = 1.0 / num_steps
    x = x0
    for i in range(num_steps):
        t_scalar = float(np.float32(i) * np.float32(dt))
        v = velocity_fn(x, _t(x, i, dt))
        score = (t_scalar * v - x) / max(1.0 - t_scalar, 1e-3)
        w = diffusion * (1.0 - t_scalar)
        eps = noise[i] if noise is not None else torch.randn(x.shape, generator=generator, device=x.device,
                                                             dtype=x.dtype)
        x = x + dt * (v + 0.5 * w * score) + math.sqrt(max(w * dt, 0.0)) * eps
    return x
