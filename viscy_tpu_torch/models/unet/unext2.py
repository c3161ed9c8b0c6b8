"""UNeXt2, the released VSCyto3D architecture (counterpart of
``viscy_tpu/models/unet/unext2.py``; reference ``unet/unext2.py:13``).

A 3D->2D projection stem, a timm ConvNeXt(-v2) multiscale encoder, the
pixel-shuffle UNeXt2 decoder and a ``PixelToVoxelHead`` that re-inflates
the 2-D features to ``out_stack_depth`` slices: ``(B, C, D, H, W)`` in and
float32 out. Every v2 block of the encoder and decoder runs the fused
MLP+GRN kernel. Parameter names and shapes equal the reference VisCy torch
model's (``viscy_tpu/training/state_dict_inventory.py``), so a released
checkpoint loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from viscy_tpu_torch.models.components.blocks import MultiscaleEncoder, UNeXt2Decoder, convnext_arch
from viscy_tpu_torch.models.components.heads import PixelToVoxelHead
from viscy_tpu_torch.models.components.stems import UNeXt2Stem
from viscy_tpu_torch.models.unet.fcmae import _dtype


class UNeXt2(nn.Module):
    """UNeXt2: stem + ConvNeXt encoder + pixel-shuffle decoder + head.

    Keyword arguments follow the JAX model so its configs load; weights are
    drawn from ``generator`` (default: a generator seeded with 0) with the
    flax initializers. ``fused_mlp`` is accepted for config compatibility:
    every v2 block runs the fused segment. ``drop_path_rate`` is the last
    encoder block's stochastic-depth rate (rising linearly from 0); it acts
    in training mode only, the keep masks drawn from the ``generator`` given
    to ``forward`` (or the ``drop_path_masks`` given there).
    """

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        in_stack_depth: int = 5,
        out_stack_depth: int | None = None,
        backbone: str = "convnextv2_tiny",
        stem_kernel_size: Sequence[int] = (5, 4, 4),
        decoder_mode: str = "pixelshuffle",
        decoder_conv_blocks: int = 2,
        head_pool: bool = False,
        head_expansion_ratio: int = 4,
        drop_path_rate: float = 0.0,
        dtype: str | torch.dtype | None = None,
        fused_mlp: bool = True,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if in_stack_depth % stem_kernel_size[0]:
            raise ValueError(
                f"Input stack depth {in_stack_depth} is not divisible by stem kernel depth {stem_kernel_size[0]}."
            )
        if decoder_mode != "pixelshuffle":
            raise ValueError(f"decoder_mode must be 'pixelshuffle', got {decoder_mode!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        depths, dims, v2 = convnext_arch(backbone)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.in_stack_depth = in_stack_depth
        self.out_stack_depth = in_stack_depth if out_stack_depth is None else out_stack_depth
        self.stem_kernel_size = tuple(stem_kernel_size)
        self.num_stages = len(dims)
        self.dtype = _dtype(dtype)
        self.stem = UNeXt2Stem(
            in_channels, dims[0], generator, self.stem_kernel_size, in_stack_depth, dtype=self.dtype
        )
        self.encoder_stages = MultiscaleEncoder(
            depths,
            dims,
            generator,
            use_grn=v2,
            ls_init_value=None if v2 else 1e-6,
            drop_path_rate=drop_path_rate,
            dtype=self.dtype,
        )
        decoder_channels = list(dims[::-1])
        decoder_channels[-1] = (self.out_stack_depth + 2) * out_channels * 2**2 * head_expansion_ratio
        self.decoder = UNeXt2Decoder(
            decoder_channels,
            [2] * (len(dims) - 1) + [self.stem_kernel_size[-1]],
            generator,
            conv_blocks=decoder_conv_blocks,
            dtype=self.dtype,
        )
        self.head = PixelToVoxelHead(
            decoder_channels[-1],
            out_channels,
            self.out_stack_depth,
            generator,
            expansion_ratio=head_expansion_ratio,
            pool=head_pool,
            dtype=self.dtype,
        )

    @property
    def num_blocks(self) -> int:
        """Reference-compatible divisible-pad exponent (6, as reference
        ``unext2.py:72-74``): the padded extent feeds the GRN statistics, so
        full-frame predictions pad as the reference does."""
        return 6

    @property
    def total_stride(self) -> int:
        """True YX downsampling factor: the divisibility the forward needs."""
        return int(self.stem_kernel_size[-1] * 2 ** (self.num_stages - 1))

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, drop_path_masks=None
    ) -> torch.Tensor:
        """``(B, C_in, D, H, W)`` -> float32 ``(B, C_out, out_stack_depth, H,
        W)``. ``generator`` draws the encoder's drop-path keep masks in
        training; ``drop_path_masks`` gives them instead (one ``(B,)`` mask
        per block with an active drop path, in block order)."""
        features = self.encoder_stages(self.stem(x), generator, drop_path_masks)
        return self.head(self.decoder(features[::-1]))
