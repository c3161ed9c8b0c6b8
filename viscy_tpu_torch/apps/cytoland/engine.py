"""Cytoland virtual-staining engine, prediction path (counterpart of
``viscy_tpu/apps/cytoland/engine.py``).

``VSUNet`` wraps the FCMAE-based UNeXt2 (``"fcmae"`` / ``"UNeXt2_2D"``)
with the reference predict step: divisible pad, forward, center crop,
optional 4-rotation test-time augmentation, and batched YX tiling with
hat-weight blending for large fields of view.
"""

from __future__ import annotations

from typing import Literal, Sequence

import torch
import torch.nn.functional as F

from viscy_tpu_torch.apps.cytoland.prediction import rotation_tta_transforms, tiled_forward_yx
from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.unet.fcmae import FullyConvolutionalMAE
from viscy_tpu_torch.training.module import TrainModule

_UNET_ARCHITECTURE = {
    "fcmae": FullyConvolutionalMAE,
    "UNeXt2_2D": FullyConvolutionalMAE,
}


def _divisible_pad(x: torch.Tensor, factor: int, pad_z: bool = False) -> torch.Tensor:
    """Zero-pad YX (and optionally Z) up to multiples of ``factor``,
    SYMMETRICALLY (floor before, ceil after) like MONAI
    ``DivisiblePad(method="symmetric")``, so ``_center_crop_to_shape`` is
    its exact inverse."""
    z, y, xx = x.shape[-3:]
    pz = (-z) % factor if pad_z else 0
    py = (-y) % factor
    px = (-xx) % factor
    if not (pz or py or px):
        return x
    return F.pad(x, (px // 2, px - px // 2, py // 2, py - py // 2, pz // 2, pz - pz // 2))


def _center_crop_to_shape(x: torch.Tensor, spatial: Sequence[int]) -> torch.Tensor:
    slices = [slice(None)] * (x.ndim - len(spatial))
    for dim, size in zip(range(x.ndim - len(spatial), x.ndim), spatial):
        start = (x.shape[dim] - size) // 2
        slices.append(slice(start, start + size))
    return x[tuple(slices)]


class VSUNet(TrainModule):
    """Virtual-staining U-Net engine (prediction).

    ``model_config`` takes the JAX engine's keys (lists become tuples;
    ``dtype`` may be a string such as ``"bfloat16"``). Weights are drawn
    from a ``torch.Generator`` seeded with ``seed``; load trained weights
    with ``model.load_state_dict`` (reference torch names). ``device``
    defaults to ``"cuda"`` and raises when no card is visible.
    """

    def __init__(
        self,
        architecture: Literal["fcmae", "UNeXt2_2D"],
        model_config: dict | None = None,
        test_time_augmentations: bool = False,
        tta_type: Literal["mean", "median", "product"] = "mean",
        tile_yx: Sequence[int] | None = None,
        tile_batch: int = 104,
        fov_shard: bool = False,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        net_class = _UNET_ARCHITECTURE.get(architecture)
        if net_class is None:
            raise ValueError(f"Architecture {architecture} not in {list(_UNET_ARCHITECTURE)}")
        if fov_shard:
            raise NotImplementedError("fov_shard (one FOV across several cards) is not ported")
        if tta_type not in ("mean", "median", "product"):
            raise ValueError(f"tta_type must be mean, median or product, got {tta_type!r}")
        device = resolve_device(device)
        model_config = dict(model_config or {})
        model_config.setdefault("pretraining", architecture == "fcmae")
        if architecture == "UNeXt2_2D":
            model_config["pretraining"] = False
        for k, v in model_config.items():
            if isinstance(v, list):
                model_config[k] = tuple(v)
        self.architecture = architecture
        self.model_config = model_config
        self.model = net_class(**model_config, generator=torch.Generator().manual_seed(seed))
        self.model.to(device)
        self.test_time_augmentations = test_time_augmentations
        self.tta_type = tta_type
        self.tile_yx = tuple(tile_yx) if tile_yx else None
        self.tile_batch = tile_batch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def _pad_forward_crop(self, source: torch.Tensor, factor: int | None = None) -> torch.Tensor:
        """Divisible-pad, forward, center-crop. ``factor`` defaults to the
        reference-compatible ``2**num_blocks`` (the padded extent feeds the
        GRN's global statistics); the tiled path passes ``total_stride``."""
        original = source.shape[2:]
        padded = _divisible_pad(source, factor or 2**self.model.num_blocks)
        return _center_crop_to_shape(self.forward(padded), original)

    def _total_stride(self) -> int:
        return self.model.total_stride

    def _full_frame_predict(self, source: torch.Tensor, factor: int | None = None):
        if not self.test_time_augmentations:
            return self._pad_forward_crop(source, factor=factor)
        orig_yx = source.shape[-2:]
        preds = []
        for fwd, inv in zip(*rotation_tta_transforms(4)):
            p = inv(self._pad_forward_crop(fwd(source), factor=factor))
            preds.append(_center_crop_to_shape(p, (p.shape[-3], *orig_yx)))
        stacked = torch.stack(preds)
        if self.tta_type == "mean":
            return stacked.mean(dim=0)
        if self.tta_type == "median":
            # numpy/jnp median: mean of the two middle values for even counts
            s = stacked.sort(dim=0).values
            n = s.shape[0]
            return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
        return torch.exp(torch.log(stacked + 1e-9).sum(dim=0))

    def predict_step(self, batch: dict) -> torch.Tensor:
        source = batch["source"]
        if self.tile_yx is not None and (
            source.shape[-2] > self.tile_yx[0] or source.shape[-1] > self.tile_yx[1]
        ):
            # tiles pad to the true stride, not the reference-compatible factor
            return tiled_forward_yx(
                lambda tiles: self._full_frame_predict(tiles, factor=self._total_stride()),
                source,
                tile=self.tile_yx,
                tile_batch=self.tile_batch,
            )
        return self._full_frame_predict(source)
