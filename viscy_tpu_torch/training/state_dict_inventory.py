"""Static torch state-dict key inventories of the released architectures
(the port's own copy of ``viscy_tpu/training/state_dict_inventory.py``).

Derived from the reference VisCy source, not from this package's models,
so the parity harness's dry runs (:mod:`viscy_tpu_torch.training.parity`)
check the port's module names against an independent list:

- FCMAE: ``viscy-models/src/viscy_models/unet/fcmae.py:456-520`` (encoder
  ``MaskedMultiscaleEncoder`` :388-422, blocks :144-193, stages :243-286,
  stem ``MaskedAdaptiveProjection`` :328-354, decoder ``UNeXt2Decoder``).
  The encoder dwconv has no bias: the block calls timm ``create_conv2d``
  without a bias kwarg (:174-180), and timm's ``create_conv2d_pad`` defaults
  ``bias=False``, unlike timm's own ConvNeXt blocks, which pass
  ``bias=conv_bias=True``.
- UNeXt2: ``unet/unext2.py:13-84`` (timm ``features_only`` ConvNeXt-v2
  encoder with ``stem_0`` replaced by Identity, ``UNeXt2Stem``,
  ``UNeXt2Decoder`` ``components/blocks.py:175-240``, ``PixelToVoxelHead``
  ``components/heads.py:594-641``).
- ContrastiveEncoder: ``contrastive/encoder.py:81-137`` (timm
  classification ConvNeXt with the stem conv and ``head.fc`` replaced by
  Identity, ``StemDepthtoChannels``, a BatchNorm projection MLP whose
  state dict holds running statistics and ``num_batches_tracked``).

The counts are those of the reference's own
``viscy-models/tests/test_state_dict_compat.py`` (UNeXt2 atto: 213 keys,
FCMAE defaults: 222, ContrastiveEncoder convnext_tiny: 194).

Every function returns ``dict[torch_key, shape]``.
"""

from __future__ import annotations

__all__ = [
    "BACKBONES",
    "fcmae_state_dict_inventory",
    "unext2_state_dict_inventory",
    "contrastive_state_dict_inventory",
    "RELEASED_ARCHITECTURES",
    "released_inventory",
]

# timm backbone table: depths, dims, and whether the block family is
# ConvNeXt-v2 (GRN, no layer scale) or v1 (layer-scale gamma, no GRN)
BACKBONES: dict[str, tuple[tuple[int, ...], tuple[int, ...], bool]] = {
    "convnextv2_atto": ((2, 2, 6, 2), (40, 80, 160, 320), True),
    "convnextv2_femto": ((2, 2, 6, 2), (48, 96, 192, 384), True),
    "convnextv2_pico": ((2, 2, 6, 2), (64, 128, 256, 512), True),
    "convnextv2_nano": ((2, 2, 8, 2), (80, 160, 320, 640), True),
    "convnextv2_tiny": ((3, 3, 9, 3), (96, 192, 384, 768), True),
    "convnextv2_base": ((3, 3, 27, 3), (128, 256, 512, 1024), True),
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768), False),
}


def _timm_block(prefix: str, c: int, *, v2: bool, conv_mlp: bool, mlp_ratio: int = 4):
    """timm ConvNeXtBlock keys (``timm/models/convnext.py``): conv_dw has a
    bias (timm passes ``bias=conv_bias=True``); v2 blocks carry mlp.grn, v1
    blocks carry a layer-scale ``gamma``; ``conv_mlp=True`` makes fc1/fc2
    1x1 convs instead of Linear."""
    h = mlp_ratio * c
    keys = {
        f"{prefix}.conv_dw.weight": (c, 1, 7, 7),
        f"{prefix}.conv_dw.bias": (c,),
        f"{prefix}.norm.weight": (c,),
        f"{prefix}.norm.bias": (c,),
        f"{prefix}.mlp.fc1.weight": (h, c, 1, 1) if conv_mlp else (h, c),
        f"{prefix}.mlp.fc1.bias": (h,),
    }
    if v2:
        keys[f"{prefix}.mlp.grn.weight"] = (h,)
        keys[f"{prefix}.mlp.grn.bias"] = (h,)
    keys[f"{prefix}.mlp.fc2.weight"] = (c, h, 1, 1) if conv_mlp else (c, h)
    keys[f"{prefix}.mlp.fc2.bias"] = (c,)
    if not v2:
        keys[f"{prefix}.gamma"] = (c,)
    return keys


def _masked_block(prefix: str, c: int, mlp_ratio: int = 4):
    """Reference MaskedConvNeXtV2Block keys (``fcmae.py:144-193``):
    dwconv **without bias** (see module docstring), ``layernorm`` (not
    ``norm``), Linear mlp with GRN."""
    h = mlp_ratio * c
    return {
        f"{prefix}.dwconv.weight": (c, 1, 7, 7),
        f"{prefix}.layernorm.weight": (c,),
        f"{prefix}.layernorm.bias": (c,),
        f"{prefix}.mlp.fc1.weight": (h, c),
        f"{prefix}.mlp.fc1.bias": (h,),
        f"{prefix}.mlp.grn.weight": (h,),
        f"{prefix}.mlp.grn.bias": (h,),
        f"{prefix}.mlp.fc2.weight": (c, h),
        f"{prefix}.mlp.fc2.bias": (c,),
    }


def _downsample(prefix: str, c_in: int, c_out: int, k: int):
    """LayerNorm2d + strided conv pair (timm ConvNeXtStage downsample /
    reference ``MaskedConvNeXtV2Stage`` ``fcmae.py:261-272``)."""
    return {
        f"{prefix}.0.weight": (c_in,),
        f"{prefix}.0.bias": (c_in,),
        f"{prefix}.1.weight": (c_out, c_in, k, k),
        f"{prefix}.1.bias": (c_out,),
    }


def _unext2_decoder(decoder_channels: list[int], conv_blocks: int, prefix: str = "decoder"):
    """UNeXt2Decoder keys (``components/blocks.py:77-240``): per stage a
    paramless pixel-shuffle upsample, then a timm ConvNeXtStage
    (``conv_mlp=True``, GRN, no layer scale) whose input is
    ``mid (= ch/stride^2) + skip (= ch/2)`` channels. The decoder is always
    built with stride-2 stages (``strides[i]=2`` for every instantiated
    stage; the trailing stem-stride entry is never consumed because
    ``stages = len(num_channels) - 1``)."""
    keys: dict[str, tuple] = {}
    for i in range(len(decoder_channels) - 1):
        ch, out = decoder_channels[i], decoder_channels[i + 1]
        c_in = ch // 4 + ch // 2  # mid + skip channels at construction
        stage = f"{prefix}.decoder_stages.{i}.conv"
        keys.update(_downsample(f"{stage}.downsample", c_in, out, 1))
        for j in range(conv_blocks):
            keys.update(_timm_block(f"{stage}.blocks.{j}", out, v2=True, conv_mlp=True))
    return keys


def _pixel_to_voxel_head(in_channels: int, out_channels: int, out_stack_depth: int, expansion_ratio: int):
    """PixelToVoxelHead keys (``components/heads.py:594-630``): paramless
    pixel-shuffle upsample, monai Convolution (conv + PReLU adn), final
    1x1x1 Conv3d; the trailing PixelShuffle is paramless."""
    mid = out_channels * expansion_ratio * 4
    c_in = in_channels // 4 // (out_stack_depth + 2)
    return {
        "head.conv.0.conv.weight": (mid, c_in, 3, 3, 3),
        "head.conv.0.conv.bias": (mid,),
        "head.conv.0.adn.A.weight": (1,),
        "head.conv.1.weight": (out_channels * 4, mid, 1, 1, 1),
        "head.conv.1.bias": (out_channels * 4,),
    }


def fcmae_state_dict_inventory(
    in_channels: int = 1,
    out_channels: int = 1,
    encoder_blocks: tuple[int, ...] = (3, 3, 9, 3),
    dims: tuple[int, ...] = (96, 192, 384, 768),
    stem_kernel_size: tuple[int, int, int] = (5, 4, 4),
    in_stack_depth: int = 5,
    decoder_conv_blocks: int = 1,
    head_conv: bool = False,
    head_conv_expansion_ratio: int = 4,
) -> dict[str, tuple]:
    """FullyConvolutionalMAE state-dict inventory (``fcmae.py:456-520``)."""
    keys: dict[str, tuple] = {}
    # MaskedAdaptiveProjection stem (fcmae.py:328-354)
    ratio = max(1, in_stack_depth // stem_kernel_size[0])
    keys["encoder.stem.conv3d.weight"] = (dims[0] // ratio, in_channels, *stem_kernel_size)
    keys["encoder.stem.conv3d.bias"] = (dims[0] // ratio,)
    keys["encoder.stem.conv2d.weight"] = (dims[0], in_channels, *stem_kernel_size[1:])
    keys["encoder.stem.conv2d.bias"] = (dims[0],)
    keys["encoder.stem.norm.weight"] = (dims[0],)
    keys["encoder.stem.norm.bias"] = (dims[0],)
    # stages (fcmae.py:409-421): stage 0 stride 1 (Identity downsample)
    chs = [dims[0], *dims]
    for i, n_blocks in enumerate(encoder_blocks):
        stage = f"encoder.stages.{i}"
        if i > 0:
            keys.update(_downsample(f"{stage}.downsample", chs[i], chs[i + 1], 2))
        for j in range(n_blocks):
            keys.update(_masked_block(f"{stage}.blocks.{j}", chs[i + 1]))
    # decoder (fcmae.py:484-497)
    decoder_channels = list(dims)[::-1]
    if head_conv:
        decoder_channels[-1] = (in_stack_depth + 2) * in_channels * 4 * head_conv_expansion_ratio
    else:
        decoder_channels[-1] = out_channels * in_stack_depth * stem_kernel_size[-1] ** 2
    keys.update(_unext2_decoder(decoder_channels, decoder_conv_blocks))
    if head_conv:
        keys.update(
            _pixel_to_voxel_head(
                decoder_channels[-1], out_channels, in_stack_depth, head_conv_expansion_ratio
            )
        )
    # else: PixelToVoxelShuffleHead is paramless (heads.py:656-678)
    return keys


def unext2_state_dict_inventory(
    in_channels: int = 1,
    out_channels: int = 1,
    in_stack_depth: int = 5,
    out_stack_depth: int | None = None,
    backbone: str = "convnextv2_tiny",
    stem_kernel_size: tuple[int, int, int] = (5, 4, 4),
    decoder_conv_blocks: int = 2,
    head_expansion_ratio: int = 4,
) -> dict[str, tuple]:
    """UNeXt2 state-dict inventory (``unext2.py:13-84``)."""
    depths, dims, v2 = BACKBONES[backbone]
    if out_stack_depth is None:
        out_stack_depth = in_stack_depth
    keys: dict[str, tuple] = {}
    ratio = in_stack_depth // stem_kernel_size[0]
    keys["stem.conv.weight"] = (dims[0] // ratio, in_channels, *stem_kernel_size)
    keys["stem.conv.bias"] = (dims[0] // ratio,)
    # timm features_only flattens stem/stages: stem_0 replaced by Identity
    # (unext2.py:48), stem_1 norm survives
    keys["encoder_stages.stem_1.weight"] = (dims[0],)
    keys["encoder_stages.stem_1.bias"] = (dims[0],)
    for i, n_blocks in enumerate(depths):
        stage = f"encoder_stages.stages_{i}"
        if i > 0:
            keys.update(_downsample(f"{stage}.downsample", dims[i - 1], dims[i], 2))
        for j in range(n_blocks):
            keys.update(_timm_block(f"{stage}.blocks.{j}", dims[i], v2=v2, conv_mlp=False))
    decoder_channels = list(dims)[::-1]
    decoder_channels[-1] = (out_stack_depth + 2) * out_channels * 4 * head_expansion_ratio
    keys.update(_unext2_decoder(decoder_channels, decoder_conv_blocks))
    keys.update(
        _pixel_to_voxel_head(
            decoder_channels[-1], out_channels, out_stack_depth, head_expansion_ratio
        )
    )
    return keys


def contrastive_state_dict_inventory(
    backbone: str = "convnext_tiny",
    in_channels: int = 1,
    in_stack_depth: int = 5,
    stem_kernel_size: tuple[int, int, int] = (5, 4, 4),
    stem_stride: tuple[int, int, int] | None = None,
    embedding_dim: int = 768,
    projection_dim: int = 128,
) -> dict[str, tuple]:
    """ContrastiveEncoder state-dict inventory (``encoder.py:81-137``).

    The timm classification model keeps its stem norm (``encoder.stem.1``)
    and head norm; ``head.fc`` is replaced by Identity. The BN projection
    layers contribute running stats + ``num_batches_tracked`` to the state
    dict (5 keys per BN)."""
    depths, dims, v2 = BACKBONES[backbone]
    if stem_stride is None:
        stem_stride = stem_kernel_size
    keys: dict[str, tuple] = {}
    # StemDepthtoChannels (stems.py:53-107)
    out_depth = (in_stack_depth - stem_kernel_size[0]) // stem_stride[0] + 1
    keys["stem.conv.weight"] = (dims[0] // out_depth, in_channels, *stem_kernel_size)
    keys["stem.conv.bias"] = (dims[0] // out_depth,)
    keys["encoder.stem.1.weight"] = (dims[0],)
    keys["encoder.stem.1.bias"] = (dims[0],)
    for i, n_blocks in enumerate(depths):
        stage = f"encoder.stages.{i}"
        if i > 0:
            keys.update(_downsample(f"{stage}.downsample", dims[i - 1], dims[i], 2))
        for j in range(n_blocks):
            keys.update(_timm_block(f"{stage}.blocks.{j}", dims[i], v2=v2, conv_mlp=False))
    keys["encoder.head.norm.weight"] = (dims[-1],)
    keys["encoder.head.norm.bias"] = (dims[-1],)

    def _bn(prefix: str, c: int):
        return {
            f"{prefix}.weight": (c,),
            f"{prefix}.bias": (c,),
            f"{prefix}.running_mean": (c,),
            f"{prefix}.running_var": (c,),
            f"{prefix}.num_batches_tracked": (),
        }

    keys["projection.0.weight"] = (embedding_dim, dims[-1])
    keys["projection.0.bias"] = (embedding_dim,)
    keys.update(_bn("projection.1", embedding_dim))
    keys["projection.3.weight"] = (projection_dim, embedding_dim)
    keys["projection.3.bias"] = (projection_dim,)
    keys.update(_bn("projection.4", projection_dim))
    return keys


# released checkpoints and the reference model recipes that describe them
# (``applications/cytoland/examples/configs/recipes/models/*.yml``; DynaCLR
# ``applications/dynaclr/configs``)
RELEASED_ARCHITECTURES: dict[str, tuple] = {
    # VSCyto3D (compmicro-czb/VSCyto3D, unext2_3d.yml)
    "vscyto3d": (
        unext2_state_dict_inventory,
        dict(in_channels=1, out_channels=2, in_stack_depth=5, backbone="convnextv2_tiny",
             stem_kernel_size=(5, 4, 4), decoder_conv_blocks=2),
    ),
    # VSCyto2D (compmicro-czb/VSCyto2D, fcmae_2d.yml)
    "vscyto2d": (
        fcmae_state_dict_inventory,
        dict(in_channels=1, out_channels=2, encoder_blocks=(3, 3, 9, 3),
             dims=(96, 192, 384, 768), decoder_conv_blocks=2,
             stem_kernel_size=(1, 2, 2), in_stack_depth=1),
    ),
    # FCMAE 3D pretrain/finetune (fcmae_3d.yml; the flagship production arch)
    "fcmae_3d": (
        fcmae_state_dict_inventory,
        dict(in_channels=1, out_channels=2, encoder_blocks=(3, 3, 9, 3),
             dims=(96, 192, 384, 768), decoder_conv_blocks=2,
             stem_kernel_size=(5, 4, 4), in_stack_depth=5),
    ),
    # DynaCLR ContrastiveEncoder (applications/dynaclr configs)
    "dynaclr_contrastive": (
        contrastive_state_dict_inventory,
        dict(backbone="convnext_tiny", in_channels=2, in_stack_depth=15,
             stem_kernel_size=(5, 4, 4)),
    ),
}


def released_inventory(name: str) -> dict[str, tuple]:
    """Inventory for a released architecture by registry name."""
    fn, kwargs = RELEASED_ARCHITECTURES[name]
    return fn(**kwargs)
