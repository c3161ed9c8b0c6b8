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
noise), so a test can hand in the JAX package's draws.

:class:`Sampler` integrates any :class:`Transport`'s drift: the ODE in
Euler, Heun or RK4 steps (``"dopri5"`` runs RK4, as in the JAX package,
whose adaptive stepping XLA cannot compile), the SDE in Euler or Heun steps
with the reference's last steps, and the ODE log-likelihood with the
Hutchinson divergence estimator. Every grid of times is computed in the
input's dtype, as JAX computes ``t0 + s * dt`` over ``jnp.arange(num_steps,
dtype=init.dtype)``.
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

__all__ = ["Transport", "Sampler", "create_transport", "euler_sampler", "heun_sampler", "sde_sampler"]


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



def _time(x: torch.Tensor, t0: float, s: float, dt: float) -> torch.Tensor:
    """The (B,) time ``t0 + s * dt``, each operation rounded to ``x``'s dtype
    as JAX rounds it."""
    c = lambda v: torch.tensor(v, dtype=x.dtype)
    return torch.full((x.shape[0],), float(c(t0) + c(s) * c(dt)), dtype=x.dtype, device=x.device)


def _step_draw(draws: torch.Tensor | None, i: int, shape, generator, device, dtype, kind: str) -> torch.Tensor:
    """Step ``i``'s draw: ``draws[i]`` when given, else a standard normal
    (``kind="normal"``) or Rademacher (``"rademacher"``) draw from
    ``generator``."""
    if draws is not None:
        return draws[i].to(device=device, dtype=dtype)
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return (torch.randint(0, 2, shape, generator=generator, device=device) * 2 - 1).to(dtype)


class Sampler:
    """ODE / SDE sampling and the ODE likelihood of a :class:`Transport`.

    Each method returns a sampler function, as the JAX package's does. The
    SDE's noise and the likelihood's Rademacher probes are tensors of shape
    ``(num_steps, *x.shape)`` when given (the JAX draws, in a test), else
    drawn from a ``torch.Generator`` one step at a time.

    Network evaluations a step: ``drift`` and ``score`` each evaluate the
    network once, so the SDE's drift (``drift + w * score``) evaluates it
    twice: two a step for Euler, four for Heun, plus two for the ``"Mean"``
    last step and one for ``"Tweedie"`` or ``"Euler"``; the ODE takes one
    (Euler), two (Heun) or four (RK4) a step; the likelihood one forward and
    one vector-Jacobian product a step."""

    def __init__(self, transport: Transport) -> None:
        self.transport = transport
        self.drift = transport.get_drift()
        self.score = transport.get_score()

    # -- ODE -------------------------------------------------------------------------------------------
    def sample_ode(self, *, sampling_method: str = "euler", num_steps: int = 50, reverse: bool = False) -> Callable:
        """Fixed-step ODE sampler ``f(init, model_fn) -> x``: ``"euler"``,
        ``"heun"`` or ``"rk4"`` (``"dopri5"`` maps to RK4); ``reverse``
        integrates the drift at ``1 - t``."""
        method = {"dopri5": "rk4"}.get(sampling_method, sampling_method)
        if method not in ("euler", "heun", "rk4"):
            raise ValueError(f"unknown ODE sampling method {sampling_method!r}")
        base_drift = self.drift
        if reverse:
            def drift(x, t, model_fn):
                return base_drift(x, torch.ones_like(t) * (1 - t), model_fn)
        else:
            drift = base_drift
        t0, t1 = self.transport.check_interval(self.transport.train_eps, self.transport.sample_eps, sde=False,
                                               is_eval=True, reverse=reverse, last_step_size=0.0)
        dt = (t1 - t0) / num_steps

        def _sample(init: torch.Tensor, model_fn: VelocityFn) -> torch.Tensor:
            tv = lambda s: _time(init, t0, s, dt)
            x = init
            for i in range(num_steps):
                if method == "euler":
                    x = x + dt * drift(x, tv(i), model_fn)
                elif method == "heun":
                    v1 = drift(x, tv(i), model_fn)
                    v2 = drift(x + dt * v1, tv(i + 1), model_fn)
                    x = x + dt * 0.5 * (v1 + v2)
                else:
                    k1 = drift(x, tv(i), model_fn)
                    k2 = drift(x + 0.5 * dt * k1, tv(i + 0.5), model_fn)
                    k3 = drift(x + 0.5 * dt * k2, tv(i + 0.5), model_fn)
                    k4 = drift(x + dt * k3, tv(i + 1), model_fn)
                    x = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            return x

        return _sample

    # -- SDE -------------------------------------------------------------------------------------------
    def _sde_drift_diffusion(self, diffusion_form: str, diffusion_norm: float):
        def diffusion_fn(x, t):
            return self.transport.path_sampler.compute_diffusion(x, t, form=diffusion_form, norm=diffusion_norm)

        def sde_drift(x, t, model_fn):
            return self.drift(x, t, model_fn) + diffusion_fn(x, t) * self.score(x, t, model_fn)

        return sde_drift, diffusion_fn

    def _last_step_fn(self, sde_drift, last_step: str | None, last_step_size: float):
        """The SDE's final step at ``t1``: none, ``"Mean"`` (an SDE-drift
        step without noise), ``"Tweedie"`` (the denoised estimate) or
        ``"Euler"`` (an ODE-drift step)."""
        if last_step is None:
            return lambda x, t, model_fn: x
        if last_step == "Mean":
            return lambda x, t, model_fn: x + sde_drift(x, t, model_fn) * last_step_size
        if last_step == "Tweedie":
            ps = self.transport.path_sampler

            def _tweedie(x, t, model_fn):
                alpha_t = expand_t_like_x(ps.compute_alpha_t(t)[0], x)
                sigma_t = expand_t_like_x(ps.compute_sigma_t(t)[0], x)
                return x / alpha_t + (sigma_t**2) / alpha_t * self.score(x, t, model_fn)

            return _tweedie
        if last_step == "Euler":
            return lambda x, t, model_fn: x + self.drift(x, t, model_fn) * last_step_size
        raise NotImplementedError(f"Last step type {last_step!r} not implemented")

    def sample_sde(
        self,
        *,
        sampling_method: str = "Euler",
        diffusion_form: str = "SBDM",
        diffusion_norm: float = 1.0,
        last_step: str | None = "Mean",
        last_step_size: float = 0.04,
        num_steps: int = 250,
    ) -> Callable:
        """SDE sampler ``f(init, model_fn, generator=None, noise=None) -> x``
        (Euler-Maruyama or stochastic Heun); step ``i`` adds
        ``sqrt(2 max(w, 0) dt) * noise[i]``."""
        if sampling_method not in ("Euler", "Heun"):
            raise ValueError(f"unknown SDE sampling method {sampling_method!r}")
        if last_step is None:
            last_step_size = 0.0
        sde_drift, sde_diffusion = self._sde_drift_diffusion(diffusion_form, diffusion_norm)
        t0, t1 = self.transport.check_interval(self.transport.train_eps, self.transport.sample_eps,
                                               diffusion_form=diffusion_form, sde=True, is_eval=True, reverse=False,
                                               last_step_size=last_step_size)
        dt = (t1 - t0) / num_steps
        last_step_fn = self._last_step_fn(sde_drift, last_step, last_step_size)

        def _sample(init: torch.Tensor, model_fn: VelocityFn, generator: torch.Generator | None = None,
                    noise: torch.Tensor | None = None) -> torch.Tensor:
            if noise is None and generator is None:
                raise ValueError("sample_sde needs a torch.Generator or its noise")
            x = init
            for i in range(num_steps):
                t = _time(init, t0, i, dt)
                w = torch.as_tensor(sde_diffusion(x, t))
                eps = _step_draw(noise, i, x.shape, generator, x.device, x.dtype, "normal")
                if sampling_method == "Euler":
                    x = x + sde_drift(x, t, model_fn) * dt + torch.sqrt(2 * torch.clamp_min(w, 0.0) * dt) * eps
                else:
                    xhat = x + torch.sqrt(2 * torch.clamp_min(w, 0.0) * dt) * eps
                    k1 = sde_drift(xhat, t, model_fn)
                    k2 = sde_drift(xhat + dt * k1, _time(init, t0, i + 1, dt), model_fn)
                    x = xhat + 0.5 * dt * (k1 + k2)
            return last_step_fn(x, torch.full((init.shape[0],), t1, dtype=init.dtype, device=init.device), model_fn)

        return _sample

    # -- likelihood ------------------------------------------------------------------------------------
    def sample_ode_likelihood(self, *, sampling_method: str = "euler", num_steps: int = 50) -> Callable:
        """Log-likelihood ``f(x, model_fn, generator=None, probes=None) ->
        (logp, z)``: Euler steps of the probability-flow ODE from data to
        noise, each adding ``dt * eps^T J eps`` (``J`` the drift's Jacobian
        at ``1 - t``, ``eps`` the step's Rademacher probe) to the change of
        log density, accumulated in float32. ``eps^T J eps`` is taken as one
        vector-Jacobian product (``torch.autograd.grad``), the scalar JAX's
        forward-mode ``jvp`` gives up to rounding; ``logp`` is
        ``prior_logp(z) - delta_logp``. The JAX method takes no other
        ``sampling_method`` either: its argument is accepted and unused."""
        base_drift = self.drift
        t0, t1 = self.transport.check_interval(self.transport.train_eps, self.transport.sample_eps, sde=False,
                                               is_eval=True, reverse=False, last_step_size=0.0)
        dt = (t1 - t0) / num_steps

        def _sample(x: torch.Tensor, model_fn: VelocityFn, generator: torch.Generator | None = None,
                    probes: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
            if probes is None and generator is None:
                raise ValueError("sample_ode_likelihood needs a torch.Generator or its probes")
            z = x.detach()
            logp = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
            axes = tuple(range(1, x.ndim))
            for i in range(num_steps):
                eps = _step_draw(probes, i, z.shape, generator, z.device, z.dtype, "rademacher")
                t = _time(z, t0, i, dt)
                t_rev = torch.ones_like(t) * (1 - t)
                with torch.enable_grad():
                    zz = z.detach().requires_grad_(True)
                    drift_val = base_drift(zz, t_rev, model_fn)
                    (vjp,) = torch.autograd.grad(drift_val, zz, eps)
                div_est = (vjp * eps).sum(dim=axes)
                z = (z + dt * (-drift_val)).detach()
                logp = logp + dt * div_est
            return self.transport.prior_logp(z) - logp, z

        return _sample


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
