"""Contrastive encoder (counterpart of
``viscy_tpu/models/contrastive/encoder.py``; reference
``contrastive/encoder.py:52``).

A ``StemDepthtoChannels`` stem (Z folded into channels), a timm ConvNeXt
backbone (v1 ``convnext_*`` blocks in plain torch, v2 ``convnextv2_*``
blocks through the fused kernel), the spatial mean and the head LayerNorm in
float32 (the embedding), and the BatchNorm projection MLP. Returns
``(embedding, projection)``. Parameter and buffer names equal the reference
torch model's (``contrastive_state_dict_inventory``): timm's ``head.fc``
is erased, as the reference erases it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from viscy_tpu_torch.models.components.blocks import LayerNorm, MultiscaleEncoder, convnext_arch
from viscy_tpu_torch.models.components.heads import ProjectionMLP
from viscy_tpu_torch.models.components.stems import StemDepthtoChannels
from viscy_tpu_torch.models.unet.fcmae import _dtype


class _ClassifierHead(nn.Module):
    """timm's classification head without its ``fc``: the LayerNorm."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.norm = LayerNorm(dim)


class ContrastiveEncoder(nn.Module):
    """ConvNeXt contrastive encoder with a 3D stem and a projection head.

    Keyword arguments follow the JAX model so its configs load; weights are
    drawn from ``generator`` (default: seeded with 0). In training mode the
    projection's BatchNorms use and update batch statistics (as flax does,
    the biased variance) and the encoder's drop path acts, its keep masks
    drawn from the ``generator`` given to ``forward`` (or given as
    ``drop_path_masks``). ``fused_mlp`` is accepted for config
    compatibility."""

    def __init__(
        self,
        backbone: str = "convnext_tiny",
        in_channels: int = 2,
        in_stack_depth: int = 15,
        stem_kernel_size: Sequence[int] = (5, 4, 4),
        stem_stride: Sequence[int] = (5, 4, 4),
        embedding_dim: int = 768,
        projection_dim: int = 128,
        drop_path_rate: float = 0.0,
        fused_mlp: bool = True,
        dtype: str | torch.dtype | None = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        depths, dims, v2 = convnext_arch(backbone)
        self.in_channels = in_channels
        self.in_stack_depth = in_stack_depth
        self.dtype = _dtype(dtype)
        self.stem = StemDepthtoChannels(
            in_channels, in_stack_depth, dims[0], generator, stem_kernel_size, stem_stride, dtype=self.dtype
        )
        self.encoder = MultiscaleEncoder(
            depths,
            dims,
            generator,
            use_grn=v2,
            ls_init_value=None if v2 else 1e-6,
            drop_path_rate=drop_path_rate,
            dtype=self.dtype,
            features_only=False,
        )
        self.encoder.head = _ClassifierHead(dims[-1])
        self.projection = ProjectionMLP(dims[-1], embedding_dim, projection_dim, generator)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, drop_path_masks=None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, C, D, H, W)`` -> float32 ``(embedding (B, dims[-1]),
        projection (B, projection_dim))``."""
        features = self.encoder(self.stem(x), generator, drop_path_masks)
        pooled = features[-1].float().mean(dim=(1, 2))
        embedding = self.encoder.head.norm(pooled, torch.float32)
        return embedding, self.projection(embedding)
