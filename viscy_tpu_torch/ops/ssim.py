"""2.5D SSIM / MS-SSIM with bf16-safe numerics (counterpart of
``viscy_tpu/ops/ssim.py``), NCDHW layout.

Uniform windows, the depth window spanning the full stack depth, statistics
in float32, contrast sensitivity clamped for bf16 training, and no depth
downsampling across MS-SSIM scales. Plain PyTorch, differentiable. The
default data range is the target's maximum over the batch: over the global
batch in a job of several processes.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from viscy_tpu_torch.parallel.mesh import global_max

_MS_SSIM_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _uniform_filter(x: torch.Tensor, kernel_size: Sequence[int]) -> torch.Tensor:
    """Mean filter (valid padding) over (D, H, W) of a (B, C, D, H, W) batch,
    in float32: a plain mean where the window spans the whole axis, else a
    prefix-sum box filter (one cumsum and one subtraction per axis)."""
    y = x.float()
    for axis, k in enumerate(kernel_size):
        ax = 2 + axis
        if k == 1:
            continue
        if k == y.shape[ax]:
            y = y.mean(dim=ax, keepdim=True)
            continue
        cs = torch.cumsum(y, dim=ax)
        cs = F.pad(cs, [0, 0] * (y.ndim - 1 - ax) + [1, 0])
        n = y.shape[ax]
        y = (cs.narrow(ax, k, n + 1 - k) - cs.narrow(ax, 0, n + 1 - k)) / k
    return y


def _ssim_and_cs(pred, target, kernel_size, data_range=1.0, k1: float = 0.01, k2: float = 0.03):
    """Per-pixel SSIM and contrast-sensitivity maps (float32)."""
    p = pred.float()
    t = target.float()
    mu_x = _uniform_filter(p, kernel_size)
    mu_y = _uniform_filter(t, kernel_size)
    mu_xx = _uniform_filter(p * p, kernel_size)
    mu_yy = _uniform_filter(t * t, kernel_size)
    mu_xy = _uniform_filter(p * t, kernel_size)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1)) * cs
    return ssim, cs


def ssim_25d(
    preds: torch.Tensor,
    target: torch.Tensor,
    in_plane_window_size: tuple[int, int] = (11, 11),
    return_contrast_sensitivity: bool = False,
    data_range: torch.Tensor | float | None = None,
):
    """SSIM for 2.5D volumes: uniform window, depth window = full depth.
    Returns the per-sample SSIM ``(B,)`` (and CS ``(B,)`` when asked)."""
    if preds.ndim != 5:
        raise ValueError(f"Input shape must be (B, C, D, H, W), got {tuple(preds.shape)}")
    if data_range is None:
        data_range = global_max(target.max().float())
    ssim_img, cs_img = _ssim_and_cs(
        preds, target, (preds.shape[2], *in_plane_window_size), data_range=data_range
    )
    ssim = ssim_img.reshape(ssim_img.shape[0], -1).mean(dim=1)
    if return_contrast_sensitivity:
        return ssim, cs_img.reshape(cs_img.shape[0], -1).mean(dim=1)
    return ssim


def _pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 in-plane average (valid), summed in float32 in window order and
    cast back to the input dtype."""
    f = x.float()
    h, w = (f.shape[-2] // 2) * 2, (f.shape[-1] // 2) * 2
    f = f[..., :h, :w]
    s = f[..., 0::2, 0::2] + f[..., 0::2, 1::2] + f[..., 1::2, 0::2] + f[..., 1::2, 1::2]
    return (s / 4.0).to(x.dtype)


def ms_ssim_25d(
    preds: torch.Tensor,
    target: torch.Tensor,
    in_plane_window_size: tuple[int, int] = (11, 11),
    clamp: bool = False,
    betas: Sequence[float] = _MS_SSIM_BETAS,
) -> torch.Tensor:
    """Multi-scale SSIM for 2.5D volumes; depth is never downsampled.

    Per-scale contrast sensitivity (the last scale's replaced by the full
    SSIM), ``data_range = max(target)`` recomputed at every scale, optional
    clamp to ``[1e-4, inf)``, scales that would shrink below the window
    dropped, beta-weighted geometric mean, batch-averaged scalar."""
    base_min = 1e-4
    min_hw = min(preds.shape[-2:])
    max_scales = 1
    while max_scales < len(betas) and (min_hw // (2**max_scales)) >= max(in_plane_window_size):
        max_scales += 1
    betas = list(betas)[:max_scales]
    mcs_list = []
    ssim = None
    p, t = preds, target
    for _ in range(len(betas)):
        ssim, cs = ssim_25d(
            p, t, in_plane_window_size, return_contrast_sensitivity=True,
            data_range=global_max(t.max().float()),
        )
        if clamp:
            cs = torch.clamp_min(cs, base_min)
        mcs_list.append(cs)
        p, t = _pool2x2(p), _pool2x2(t)
    if clamp:
        ssim = torch.clamp_min(ssim, base_min)
    mcs_list[-1] = ssim
    mcs = torch.stack(mcs_list)
    b = torch.tensor(betas, dtype=torch.float32, device=mcs.device)[:, None]
    return torch.prod(mcs**b, dim=0).mean()
