"""In-focus z-slice detection by midband spatial-frequency power
(counterpart of ``viscy_tpu/apps/qc/focus.py``).

The in-focus slice maximizes the power of the transverse spectrum in a
midband annulus: frequencies between ``midband_fractions * f_cutoff``,
``f_cutoff = 2 NA / lambda``. One ``torch.fft.fft2`` over a (Z, Y, X)
stack in float32, on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from viscy_tpu_torch.device import resolve_device

_logger = logging.getLogger("viscy_tpu_torch")


def band_power(zyx, NA_det: float, lambda_ill: float, pixel_size: float,
               midband_fractions: tuple[float, float] = (0.125, 0.25), device: str | torch.device = "cuda"
               ) -> torch.Tensor:
    """Per-slice float32 power of a (Z, Y, X) stack in the midband annulus,
    on ``device``."""
    dev = resolve_device(device)
    zyx = torch.as_tensor(np.asarray(zyx) if not isinstance(zyx, torch.Tensor) else zyx).to(dev, torch.float32)
    _, y, x = zyx.shape
    fy = torch.fft.fftfreq(y, d=pixel_size, device=dev)
    fx = torch.fft.fftfreq(x, d=pixel_size, device=dev)
    frr = torch.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    f_cutoff = 2 * NA_det / lambda_ill
    lo, hi = midband_fractions
    band = (frr > lo * f_cutoff) & (frr < hi * f_cutoff)
    spectrum = torch.fft.fft2(zyx, dim=(1, 2)).abs()
    return (spectrum * band[None]).sum(dim=(1, 2))


def focus_from_transverse_band(zyx, NA_det: float, lambda_ill: float, pixel_size: float,
                               midband_fractions: tuple[float, float] = (0.125, 0.25),
                               device: str | torch.device = "cuda") -> int:
    """The index of the in-focus slice of a (Z, Y, X) stack."""
    return int(torch.argmax(band_power(zyx, NA_det, lambda_ill, pixel_size, midband_fractions, device)))


class FocusSliceMetric:
    """The focus slice of each (FOV, channel, timepoint): the per-FOV mean and
    standard deviation over timepoints and each timepoint's index."""

    field_name = "focus_slice"

    def __init__(self, NA_det: float, lambda_ill: float, pixel_size: float, channel_names: list[str],
                 midband_fractions: tuple[float, float] = (0.125, 0.25), device: str | torch.device = "cuda") -> None:
        self.NA_det = NA_det
        self.lambda_ill = lambda_ill
        self.pixel_size = pixel_size
        self.channel_names = channel_names
        self.midband_fractions = tuple(midband_fractions)
        self.device = resolve_device(device)

    def channels(self) -> list[str]:
        return self.channel_names

    def __call__(self, position, channel_name: str, channel_index: int, num_workers: int = 4) -> dict:
        """Read each timepoint's (Z, Y, X) stack of ``channel_index`` through
        the port's OME-Zarr reader and find its focus slice."""
        image = position["0"]
        focus_indices = np.array([
            focus_from_transverse_band(image[t, channel_index], self.NA_det, self.lambda_ill, self.pixel_size,
                                       self.midband_fractions, self.device)
            for t in range(image.shape[0])
        ], dtype=int)
        return {
            "fov_statistics": {
                "z_focus_mean": float(focus_indices.mean()),
                "z_focus_std": float(focus_indices.std()),
            },
            "per_timepoint": {str(t): int(i) for t, i in enumerate(focus_indices)},
        }
