"""Frozen foundation-model feature extractors (counterpart of
``viscy_tpu/models/foundation/wrappers.py``; reference
``foundation/dinov3.py``, ``openphenom.py``, ``cell_dino.py``).

Each wrapper does the reference's inline preprocessing (the center Z
slice, per-sample min-max, grayscale or two channels to RGB, resize to the
ViT's working resolution as ``jax.image.resize(..., "linear")`` does,
ImageNet normalization) and runs a frozen :class:`DinoViT`. Weights load
from a local HF checkpoint (:meth:`load_backbone`); nothing is fetched.
"""

from __future__ import annotations

import torch
from torch import nn

from viscy_tpu_torch.models.foundation.vit import DinoViT, resize_linear

__all__ = ["CellDinoModel", "DINOv3Model", "OpenPhenomModel", "preprocess"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess(x: torch.Tensor, resize_to: int) -> torch.Tensor:
    """``(B, C, Z, Y, X)`` or ``(B, C, Y, X)`` -> ``(B, 3, resize_to,
    resize_to)`` normalized RGB: the center Z slice, each sample min-maxed
    over all its channels and pixels (range floored at 1e-6), one channel
    repeated three times or two channels followed by the first, at most
    three kept, resized and ImageNet-normalized."""
    if x.ndim == 5:
        x = x[:, :, x.shape[2] // 2]
    flat = x.reshape(x.shape[0], -1)
    lo = flat.min(dim=1).values.reshape(-1, 1, 1, 1)
    hi = flat.max(dim=1).values.reshape(-1, 1, 1, 1)
    x = (x - lo) / torch.clamp_min(hi - lo, 1e-6)
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    elif x.shape[1] == 2:
        x = torch.cat([x, x[:, :1]], dim=1)
    x = resize_linear(x[:, :3], {2: resize_to, 3: resize_to})
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


class _FrozenViTWrapper(nn.Module):
    """A frozen ViT feature extractor: ``forward(x) -> (features,
    projections)``, the ``feature`` output of the backbone (``"cls"``,
    ``"patch_mean"``) and ``projection(features)`` (the features again
    without a projection). The parameters never train (``requires_grad``
    off); ``freeze`` is accepted for the reference's configs.
    ``weights_path`` is the local checkpoint :meth:`load_backbone` reads."""

    patch_size_default = 14
    model_name_default = ""

    def __init__(
        self,
        embed_dim: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        patch_size: int | None = None,
        resize_to: int = 224,
        feature: str = "cls",
        freeze: bool = True,
        weights_path: str | None = None,
        projection: nn.Module | None = None,
        model_name: str | None = None,
        seed: int = 0,
    ) -> None:
        super().__init__()
        self.embed_dim, self.depth, self.num_heads = embed_dim, depth, num_heads
        self.patch_size = self.patch_size_default if patch_size is None else patch_size
        self.resize_to = int(resize_to)
        self.feature = feature
        self.freeze = freeze
        self.weights_path = weights_path
        self.model_name = self.model_name_default if model_name is None else model_name
        self.backbone = DinoViT(img_size=self.resize_to, patch_size=self.patch_size, embed_dim=embed_dim,
                                depth=depth, num_heads=num_heads, generator=torch.Generator().manual_seed(seed))
        self.projection = projection
        self.requires_grad_(False)

    def load_backbone(self, checkpoint_path: str | None = None) -> None:
        """Load a local HF DINOv2 checkpoint into the backbone
        (:func:`~viscy_tpu_torch.models.foundation.convert.load_dinov2_checkpoint`)."""
        from viscy_tpu_torch.models.foundation.convert import load_dinov2_checkpoint

        checkpoint_path = checkpoint_path or self.weights_path
        if checkpoint_path is None:
            raise ValueError("no checkpoint_path given and weights_path is unset")
        sd = load_dinov2_checkpoint(checkpoint_path, depth=self.depth, num_heads=self.num_heads)
        self.backbone.load_state_dict(sd, strict=True)

    def _project(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.projection is not None:
            return feats, self.projection(feats)
        return feats, feats

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self._project(self.backbone(preprocess(x, self.resize_to))[self.feature])


class DINOv3Model(_FrozenViTWrapper):
    """DINOv3-style frozen extractor (reference ``dinov3.py``): the DINOv2
    backbone at patch 16, as the JAX package builds it (learned positions,
    no register tokens, no rotary embedding; so a Hugging Face DINOv3
    checkpoint does not convert into it, in JAX as here)."""

    patch_size_default = 16
    model_name_default = "facebook/dinov3-vits16"


class CellDinoModel(_FrozenViTWrapper):
    """Cell-finetuned DINOv2 ViT (reference ``cell_dino.py``): ``img_size``,
    when given, is the working resolution (it overrides ``resize_to``)."""

    def __init__(self, *args, img_size: int | None = None, **kwargs) -> None:
        if img_size is not None:
            kwargs["resize_to"] = int(img_size)
        super().__init__(*args, **kwargs)


class OpenPhenomModel(_FrozenViTWrapper):
    """OpenPhenom-style channel-agnostic extractor (reference
    ``openphenom.py``): each channel of the center Z slice is preprocessed
    (min-maxed on its own) and embedded separately; the features are
    averaged over the channels."""

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if x.ndim == 5:
            x = x[:, :, x.shape[2] // 2]
        feats = [self.backbone(preprocess(x[:, c : c + 1, None], self.resize_to))[self.feature]
                 for c in range(x.shape[1])]
        return self._project(torch.stack(feats).mean(dim=0))
