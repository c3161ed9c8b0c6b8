"""GAN losses (counterpart of ``viscy_tpu/models/gan/losses.py``; reference
``gan/losses.py`` and dynacell ``engine.py:700``): the mode-dispatched
discriminator and generator losses (lsgan, nonsat, rpgan, hinge) averaged
over scales, feature matching, LeCam regularization, and the
reference-named per-scale losses with the R1 / R2 zero-centred gradient
penalties. Logits are cast to float32 first, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Literal

import torch
import torch.nn.functional as F


def _as_list(logits) -> list:
    return list(logits) if isinstance(logits, (list, tuple)) else [logits]


def gan_loss_d(real_logits, fake_logits, mode: Literal["lsgan", "hinge", "nonsat", "rpgan"] = "lsgan"):
    """Discriminator loss over (multiscale) patch logits, the mean over scales."""
    loss = 0.0
    reals, fakes = _as_list(real_logits), _as_list(fake_logits)
    for r, f in zip(reals, fakes):
        r, f = r.float(), f.float()
        if mode == "lsgan":
            loss = loss + ((r - 1.0) ** 2).mean() + (f**2).mean()
        elif mode == "nonsat":
            loss = loss + F.softplus(-r).mean() + F.softplus(f).mean()
        elif mode == "rpgan":
            loss = loss + F.softplus(-(r - f)).mean()
        else:
            loss = loss + F.relu(1.0 - r).mean() + F.relu(1.0 + f).mean()
    return loss / len(reals)


def gan_loss_g(fake_logits, mode: Literal["lsgan", "hinge", "nonsat", "rpgan"] = "lsgan", real_logits=None):
    """Generator adversarial loss, the mean over scales (``rpgan`` needs the
    real logits too)."""
    fakes = _as_list(fake_logits)
    reals = _as_list(real_logits) if real_logits is not None else [None] * len(fakes)
    loss = 0.0
    for f, r in zip(fakes, reals):
        f = f.float()
        if mode == "lsgan":
            loss = loss + ((f - 1.0) ** 2).mean()
        elif mode == "nonsat":
            loss = loss + F.softplus(-f).mean()
        elif mode == "rpgan":
            loss = loss + F.softplus(-(f - r.float())).mean()
        else:
            loss = loss - f.mean()
    return loss / len(fakes)


def feature_matching_loss(real_features, fake_features) -> torch.Tensor:
    """Mean L1 between discriminator features of real and fake inputs: per
    layer, averaged over layers; a list of per-scale lists is averaged over
    scales."""
    if real_features and isinstance(real_features[0], (list, tuple)):
        return torch.stack([feature_matching_loss(r, f) for r, f in zip(real_features, fake_features)]).mean()
    loss = 0.0
    for r, f in zip(real_features, fake_features):
        loss = loss + (r.float() - f.float()).abs().mean()
    return loss / max(len(real_features), 1)


def lecam_penalty(real_logits, fake_logits, ema_real, ema_fake) -> torch.Tensor:
    """LeCam regularization (Tseng et al. 2021): every real logit pulled
    toward the fake EMA and every fake one toward the real EMA."""
    r = torch.cat([x.reshape(-1) for x in _as_list(real_logits)])
    f = torch.cat([x.reshape(-1) for x in _as_list(fake_logits)])
    return ((r - ema_fake) ** 2).mean() + ((f - ema_real) ** 2).mean()


def mean_logit(logits) -> torch.Tensor:
    """The mean of every scale's logits together, float32."""
    return torch.cat([x.reshape(-1).float() for x in _as_list(logits)]).mean()


# -- reference-named API (viscy_models/gan/losses.py) ----------------------------------------------


def _validate_scales(d_real, d_fake=None) -> None:
    if len(_as_list(d_real)) == 0:
        raise ValueError("Expected at least one scale of logits.")
    if d_fake is not None and len(_as_list(d_real)) != len(_as_list(d_fake)):
        raise ValueError(f"Number of scales must match: {len(_as_list(d_real))} vs {len(_as_list(d_fake))}")


def _per_scale(fn, *scales) -> torch.Tensor:
    return torch.stack([fn(*xs) for xs in zip(*scales)]).mean()


def lsgan_d_loss(d_real, d_fake) -> torch.Tensor:
    """Per scale ``0.5 * (mean((real - 1)^2) + mean(fake^2))``, mean over scales."""
    _validate_scales(d_real, d_fake)
    return _per_scale(lambda r, f: 0.5 * (((r.float() - 1.0) ** 2).mean() + (f.float() ** 2).mean()),
                      _as_list(d_real), _as_list(d_fake))


def lsgan_g_loss(d_fake) -> torch.Tensor:
    """Per scale ``mean((fake - 1)^2)``, mean over scales."""
    _validate_scales(d_fake)
    return _per_scale(lambda f: ((f.float() - 1.0) ** 2).mean(), _as_list(d_fake))


def nonsat_d_loss(d_real, d_fake) -> torch.Tensor:
    """Per scale ``mean(softplus(-real)) + mean(softplus(fake))``."""
    _validate_scales(d_real, d_fake)
    return _per_scale(lambda r, f: F.softplus(-r.float()).mean() + F.softplus(f.float()).mean(),
                      _as_list(d_real), _as_list(d_fake))


def nonsat_g_loss(d_fake) -> torch.Tensor:
    """Per scale ``mean(softplus(-fake))``."""
    _validate_scales(d_fake)
    return _per_scale(lambda f: F.softplus(-f.float()).mean(), _as_list(d_fake))


def rpgan_d_loss(d_real, d_fake) -> torch.Tensor:
    """Relativistic pairing (R3GAN), per scale ``mean(softplus(-(real - fake)))``."""
    _validate_scales(d_real, d_fake)
    return _per_scale(lambda r, f: F.softplus(-(r.float() - f.float())).mean(), _as_list(d_real), _as_list(d_fake))


def rpgan_g_loss(d_real, d_fake) -> torch.Tensor:
    """Per scale ``mean(softplus(real - fake))``."""
    _validate_scales(d_real, d_fake)
    return _per_scale(lambda r, f: F.softplus(r.float() - f.float()).mean(), _as_list(d_real), _as_list(d_fake))


def _zero_centered_grad_penalty(discriminator: Callable, sample_input: torch.Tensor,
                                create_graph: bool = True) -> torch.Tensor:
    """Per scale ``||d D_scale(x) / dx||^2`` summed over channels and space,
    the mean over the batch, then over scales: one forward, one pullback a
    scale. ``create_graph`` keeps the graph for the discriminator's own
    gradient (a double backward)."""
    x = sample_input.detach().float().requires_grad_(True)
    scales = [s.float() for s in _as_list(discriminator(x))]
    per_scale = []
    for i, s in enumerate(scales):
        (grad,) = torch.autograd.grad(s, x, torch.ones_like(s), retain_graph=True, create_graph=create_graph)
        per_scale.append((grad.reshape(grad.shape[0], -1) ** 2).sum(dim=1).mean())
    return torch.stack(per_scale).mean()


def r1_penalty(discriminator: Callable, real_input: torch.Tensor) -> torch.Tensor:
    """R1 zero-centred gradient penalty on real input (Mescheder 2018);
    ``discriminator`` returns per-scale logits."""
    return _zero_centered_grad_penalty(discriminator, real_input)


def r2_penalty(discriminator: Callable, fake_input: torch.Tensor) -> torch.Tensor:
    """R2 penalty: R1's form on fake samples (R3GAN)."""
    return _zero_centered_grad_penalty(discriminator, fake_input)


__all__ = [
    "feature_matching_loss", "gan_loss_d", "gan_loss_g", "lecam_penalty", "lsgan_d_loss", "lsgan_g_loss",
    "mean_logit", "nonsat_d_loss", "nonsat_g_loss", "r1_penalty", "r2_penalty", "rpgan_d_loss", "rpgan_g_loss",
]
