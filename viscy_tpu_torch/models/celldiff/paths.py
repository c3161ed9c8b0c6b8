"""Coupling plans of the flow-matching transport paths (counterpart of
``viscy_tpu/models/celldiff/paths.py``; reference
``celldiff/modules/transport/path.py:15-397``): the linear interpolant
(``ICPlan``), the variance-preserving plan (``VPCPlan``) and the geometric
vector path (``GVPCPlan``), with the score / velocity / noise / denoised
conversions the samplers need. Every method takes and returns tensors.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ICPlan", "VPCPlan", "GVPCPlan", "expand_t_like_x"]


def expand_t_like_x(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B,) time vector (or a scalar) shaped to broadcast against ``x``."""
    t = torch.as_tensor(t)
    if t.ndim == 0:
        t = t[None]
    return t.reshape((-1,) + (1,) * (x.ndim - 1))


class ICPlan:
    """Linear interpolant ``x_t = t * x1 + (1 - t) * x0``."""

    def __init__(self, sigma: float = 0.0) -> None:
        self.sigma = sigma

    def compute_alpha_t(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Data coefficient ``t`` and its derivative."""
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Noise coefficient ``1 - t`` and its derivative."""
        return 1 - t, -torch.ones_like(t)

    def compute_d_alpha_alpha_ratio_t(self, t: torch.Tensor) -> torch.Tensor:
        """``d_alpha_t / alpha_t = 1 / t``, t clamped at 1e-7."""
        return 1 / torch.clamp_min(t, 1e-7)

    def compute_drift(self, x: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The score-parametrized SDE's ``(-drift, diffusion)``."""
        t = expand_t_like_x(t, x)
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        return -(alpha_ratio * x), alpha_ratio * (sigma_t**2) - sigma_t * d_sigma_t

    def compute_diffusion(self, x: torch.Tensor, t: torch.Tensor, form: str = "constant",
                          norm: float = 1.0) -> torch.Tensor:
        """The SDE diffusion coefficient in the reference's six forms."""
        t = expand_t_like_x(t, x)
        if form == "constant":
            return torch.as_tensor(norm)
        if form == "SBDM":
            return norm * self.compute_drift(x, t)[1]
        if form == "sigma":
            return norm * self.compute_sigma_t(t)[0]
        if form == "linear":
            return norm * (1 - t)
        if form == "decreasing":
            return 0.25 * (norm * torch.cos(math.pi * t) + 1) ** 2
        if form == "increasing-decreasing":
            return norm * torch.sin(math.pi * t) ** 2
        raise NotImplementedError(f"Diffusion form {form!r} not implemented")

    def get_score_from_velocity(self, velocity: torch.Tensor, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = sigma_t**2 - reverse_alpha_ratio * d_sigma_t * sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_score_from_denoised(self, denoised: torch.Tensor, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = expand_t_like_x(t, x)
        alpha_t, _ = self.compute_alpha_t(t)
        sigma_t, _ = self.compute_sigma_t(t)
        return (alpha_t * denoised - x) / (sigma_t**2)

    def get_noise_from_velocity(self, velocity: torch.Tensor, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = reverse_alpha_ratio * d_sigma_t - sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_velocity_from_score(self, score: torch.Tensor, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = expand_t_like_x(t, x)
        drift, var = self.compute_drift(x, t)
        return var * score - drift

    def compute_mu_t(self, t: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        """Mean of p_t: ``alpha_t * x1 + sigma_t * x0``."""
        t = expand_t_like_x(t, x1)
        alpha_t, _ = self.compute_alpha_t(t)
        sigma_t, _ = self.compute_sigma_t(t)
        return alpha_t * x1 + sigma_t * x0

    def compute_xt(self, t: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        return self.compute_mu_t(t, x0, x1)

    def compute_ut(self, t: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
        """The velocity target ``d/dt x_t``."""
        t = expand_t_like_x(t, x1)
        _, d_alpha_t = self.compute_alpha_t(t)
        _, d_sigma_t = self.compute_sigma_t(t)
        return d_alpha_t * x1 + d_sigma_t * x0

    def plan(self, t: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
        """The training triple ``(t, x_t, u_t)``."""
        xt = self.compute_xt(t, x0, x1)
        return t, xt, self.compute_ut(t, x0, x1, xt)


class VPCPlan(ICPlan):
    """Variance-preserving plan with exponential coefficient schedules."""

    def __init__(self, sigma_min: float = 0.1, sigma_max: float = 20.0) -> None:
        super().__init__()
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def _log_mean_coeff(self, t: torch.Tensor) -> torch.Tensor:
        return -0.25 * ((1 - t) ** 2) * (self.sigma_max - self.sigma_min) - 0.5 * (1 - t) * self.sigma_min

    def _d_log_mean_coeff(self, t: torch.Tensor) -> torch.Tensor:
        return 0.5 * (1 - t) * (self.sigma_max - self.sigma_min) + 0.5 * self.sigma_min

    def compute_alpha_t(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        alpha_t = torch.exp(self._log_mean_coeff(t))
        return alpha_t, alpha_t * self._d_log_mean_coeff(t)

    def compute_sigma_t(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        p_sigma_t = 2 * self._log_mean_coeff(t)
        sigma_t = torch.sqrt(1 - torch.exp(p_sigma_t))
        d_sigma_t = torch.exp(p_sigma_t) * (2 * self._d_log_mean_coeff(t)) / (-2 * sigma_t)
        return sigma_t, d_sigma_t

    def compute_d_alpha_alpha_ratio_t(self, t: torch.Tensor) -> torch.Tensor:
        return self._d_log_mean_coeff(t)

    def compute_drift(self, x: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        t = expand_t_like_x(t, x)
        beta_t = self.sigma_min + (1 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2


class GVPCPlan(ICPlan):
    """Geometric vector path: ``alpha_t = sin(pi t / 2)``, ``sigma_t = cos(pi t / 2)``."""

    def compute_alpha_t(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return torch.sin(t * math.pi / 2), math.pi / 2 * torch.cos(t * math.pi / 2)

    def compute_sigma_t(self, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return torch.cos(t * math.pi / 2), -math.pi / 2 * torch.sin(t * math.pi / 2)

    def compute_d_alpha_alpha_ratio_t(self, t: torch.Tensor) -> torch.Tensor:
        return math.pi / (2 * torch.clamp_min(torch.tan(t * math.pi / 2), 1e-7))
