"""Flow-matching virtual staining around :class:`CELLDiffNet` (counterpart
of ``viscy_tpu/apps/dynacell/celldiff_wrapper.py``; reference
``applications/dynacell/src/dynacell/celldiff_wrapper.py``).

``CELLDiff3DVS`` owns its network and samples in three modes: a single ODE
solve from noise, the whole Euler trajectory, and tiled generation with
stride equal to the patch whose last tile on each axis snaps to the edge.
Noise comes from an explicit ``torch.Generator`` or is passed in (the JAX
draws, in a test).
"""

from __future__ import annotations

import itertools
from typing import Literal, Sequence

import torch
from torch import nn

from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.celldiff import CELLDiffNet, create_transport, euler_sampler, heun_sampler
from viscy_tpu_torch.models.celldiff.transport import VelocityFn, _t

__all__ = ["CELLDiff3DVS", "trajectory_sampler"]


def trajectory_sampler(velocity_fn: VelocityFn, x0: torch.Tensor, num_steps: int = 100) -> torch.Tensor:
    """Euler integration from ``x0`` (t = 0) that keeps every state:
    ``(num_steps + 1, B, C, ...)``, index 0 the noise, index -1 the sample."""
    dt = 1.0 / num_steps
    states = [x0]
    for i in range(num_steps):
        states.append(states[-1] + dt * velocity_fn(states[-1], _t(x0, i, dt)))
    return torch.stack(states)


def tile_origins(size: int, patch: int) -> list[int]:
    """Tile starts along one axis at stride ``patch``; the last tile snaps to
    the edge, so it overlaps the one before when ``patch`` does not divide
    ``size``."""
    starts = list(range(0, size - patch + 1, patch))
    if not starts or starts[-1] + patch < size:
        starts.append(size - patch)
    return starts


class CELLDiff3DVS(nn.Module):
    """Flow-matching virtual staining: ``net`` (a :class:`CELLDiffNet`, or
    the keyword arguments of one, lists becoming tuples, its weights drawn
    from a generator seeded with ``seed``), the transport of
    ``create_transport`` (``prediction``, ``t_sampler``, ``path_type``,
    ``loss_weight``, ``train_eps``, ``sample_eps``) and the Euler or Heun
    sampler. ``device`` defaults to ``"cuda"``."""

    def __init__(
        self,
        net: CELLDiffNet | dict | None = None,
        prediction: Literal["velocity", "noise", "score", "denoised"] = "velocity",
        t_sampler: Literal["uniform", "logit-normal"] = "uniform",
        sampler: Literal["euler", "heun"] = "euler",
        path_type: str = "Linear",
        loss_weight: str | None = None,
        train_eps: float | None = None,
        sample_eps: float | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        if not isinstance(net, CELLDiffNet):
            cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in (net or {}).items()}
            net = CELLDiffNet(**cfg, generator=torch.Generator().manual_seed(seed))
        self.net = net.to(device)
        self.path_type = path_type
        self.prediction = prediction
        self.transport = create_transport(path_type=path_type, prediction=prediction, loss_weight=loss_weight,
                                          train_eps=train_eps, sample_eps=sample_eps, t_sampler=t_sampler)
        self._sampler = euler_sampler if sampler == "euler" else heun_sampler

    def _velocity_fn(self, phase: torch.Tensor) -> VelocityFn:
        return lambda xt, t: self.net(xt, phase, t)

    def loss(self, phase: torch.Tensor, target: torch.Tensor, generator: torch.Generator | None = None,
             t: torch.Tensor | None = None, x0: torch.Tensor | None = None) -> torch.Tensor:
        """The flow-matching training loss; the noise ``x0`` and times ``t``
        are drawn from ``generator`` unless given."""
        return self.transport.training_loss(self._velocity_fn(phase), target, generator, t, x0)

    def _noise_like_target(self, phase: torch.Tensor, generator: torch.Generator | None,
                           x0: torch.Tensor | None) -> torch.Tensor:
        if x0 is not None:
            return x0.to(device=phase.device, dtype=torch.float32)
        if generator is None:
            raise ValueError("generation needs a torch.Generator or the noise x0")
        shape = (phase.shape[0], self.net.out_channels, *phase.shape[2:])
        return torch.randn(shape, generator=generator, device=phase.device, dtype=torch.float32)

    def generate(self, phase: torch.Tensor, num_steps: int = 100, generator: torch.Generator | None = None,
                 x0: torch.Tensor | None = None) -> torch.Tensor:
        """ODE sample of the target conditioned on ``phase``, from the noise
        ``x0`` (``(B, out_channels, *phase.shape[2:])``, float32) or a draw."""
        return self._sampler(self._velocity_fn(phase), self._noise_like_target(phase, generator, x0), num_steps)

    def generate_trajectory(self, phase: torch.Tensor, num_steps: int = 100,
                            generator: torch.Generator | None = None,
                            x0: torch.Tensor | None = None) -> torch.Tensor:
        """The Euler trajectory ``(num_steps + 1, B, C, D, H, W)``."""
        return trajectory_sampler(self._velocity_fn(phase), self._noise_like_target(phase, generator, x0),
                                  num_steps)

    def generate_sliding_window(
        self,
        phase: torch.Tensor,
        num_steps: int = 100,
        patch_size: Sequence[int] | None = None,
        generator: torch.Generator | None = None,
        x0s: Sequence[torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """Tiled generation: stride equals the patch (each axis
        ``min(patch, size)``; ``patch_size`` defaults to the net's
        ``input_spatial_size``), the last tile on each axis snaps to the
        edge and overwrites the overlap, tiles in ``itertools.product``
        order. Tile ``k`` starts from ``x0s[k]`` when given, else from a
        draw of ``generator``, tile after tile."""
        if patch_size is None:
            patch_size = self.net.input_spatial_size
        if patch_size is None:
            raise ValueError("patch_size is required when the net has no input_spatial_size")
        spatial = tuple(phase.shape[2:])
        patch = tuple(min(p, s) for p, s in zip(patch_size, spatial))
        out = torch.zeros((phase.shape[0], self.net.out_channels, *spatial), dtype=torch.float32,
                          device=phase.device)
        grids = [tile_origins(s, p) for s, p in zip(spatial, patch)]
        for k, starts in enumerate(itertools.product(*grids)):
            sl = (slice(None), slice(None)) + tuple(slice(st, st + p) for st, p in zip(starts, patch))
            out[sl] = self.generate(phase[sl], num_steps, generator, None if x0s is None else x0s[k])
        return out
