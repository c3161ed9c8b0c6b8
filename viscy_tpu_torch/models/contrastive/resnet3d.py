"""3D ResNet encoder for contrastive learning (counterpart of
``viscy_tpu/models/contrastive/resnet3d.py``): basic-block ResNet over
``(B, C, D, H, W)`` volumes with flax-semantics BatchNorms, returning
``(embedding, projection)`` like ``ContrastiveEncoder``. Convolutions pad
as flax's ``"SAME"`` (the extra pixel of an odd total on the far side)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viscy_tpu_torch.models.components.blocks import BatchNorm, Conv, Linear
from viscy_tpu_torch.models.components.heads import ProjectionMLP


def _conv_same(conv: Conv, x: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    """Bias-free conv3d with flax ``padding="SAME"`` on NCDHW ``x``."""
    pads = []
    for size, k, s in zip(x.shape[2:], conv.weight.shape[2:], stride):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    x = F.pad(x, [p for pair in reversed(pads) for p in pair])
    return F.conv3d(x, conv.weight, None, tuple(stride))


def _bn(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    return bn(x.movedim(1, -1)).movedim(-1, 1)


class BasicBlock3D(nn.Module):
    """conv-BN-ReLU-conv-BN plus the (projected when the shape changes)
    shortcut, then ReLU."""

    def __init__(self, in_ch: int, channels: int, stride: Sequence[int], generator: torch.Generator) -> None:
        super().__init__()
        self.stride = tuple(stride)
        self.conv1 = Conv(in_ch, channels, (3, 3, 3), generator, bias=False)
        self.bn1 = BatchNorm(channels)
        self.conv2 = Conv(channels, channels, (3, 3, 3), generator, bias=False)
        self.bn2 = BatchNorm(channels)
        self.proj_conv = self.proj_bn = None
        if in_ch != channels or any(s > 1 for s in self.stride):
            self.proj_conv = Conv(in_ch, channels, (1, 1, 1), generator, bias=False)
            self.proj_bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(_bn(self.bn1, _conv_same(self.conv1, x, self.stride)))
        y = _bn(self.bn2, _conv_same(self.conv2, y, (1, 1, 1)))
        shortcut = x if self.proj_conv is None else _bn(self.proj_bn, _conv_same(self.proj_conv, x, self.stride))
        return torch.relu(y + shortcut)


class ResNet3dEncoder(nn.Module):
    """3D ResNet backbone over ``(B, C, D, H, W)``: a (3, 7, 7) stride (1, 2,
    2) stem conv, basic-block layers (the first block of every layer after
    the first strides (1, 2, 2), channels doubling to at most 512), the mean
    over (D, H, W), a Linear to ``embedding_dim`` and the projection MLP."""

    def __init__(
        self,
        in_channels: int = 2,
        base_channels: int = 32,
        layers: Sequence[int] = (2, 2, 2, 2),
        embedding_dim: int = 512,
        projection_dim: int = 128,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.stem_conv = Conv(in_channels, base_channels, (3, 7, 7), generator, bias=False)
        self.stem_bn = BatchNorm(base_channels)
        self.layers = nn.ModuleList()
        ch = in_ch = base_channels
        for i, depth in enumerate(layers):
            blocks = nn.ModuleList()
            for j in range(depth):
                stride = (1, 2, 2) if (i > 0 and j == 0) else (1, 1, 1)
                blocks.append(BasicBlock3D(in_ch, ch, stride, generator))
                in_ch = ch
            self.layers.append(blocks)
            ch = min(ch * 2, 512) if i < len(layers) - 1 else ch
        self.fc = Linear(in_ch, embedding_dim, generator)
        self.projection = ProjectionMLP(embedding_dim, embedding_dim, projection_dim, generator)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = torch.relu(_bn(self.stem_bn, _conv_same(self.stem_conv, x, (1, 2, 2))))
        for blocks in self.layers:
            for block in blocks:
                h = block(h)
        embedding = F.linear(h.mean(dim=(2, 3, 4)), self.fc.weight, self.fc.bias)
        return embedding, self.projection(embedding)
