"""flax parameter trees -> reference VisCy torch ``state_dict``s (the inverse
of ``viscy_tpu/training/convert.py``'s ``_FCMAE_RULES``, ``_UNEXT2_RULES``,
``_CONTRASTIVE_RULES`` and its 3-D U-Net and ViT-bottleneck rules, a
bridge for the JAX ``ResNet3dEncoder``, and the inverse of
``viscy_tpu/models/foundation/convert.py``'s DINOv2 rules for ``DinoViT``
and the foundation wrappers).

The port's models carry the reference torch names and layouts, so weights
cross between the two packages through these bridges one way and
``viscy_tpu.training.convert``'s converters the other. The rules are the
port's own copy.

Layout transposes (flax -> torch):

- Conv2d ``(kh, kw, I, O)``      -> ``(O, I, kh, kw)`` (depthwise included)
- Conv3d ``(kd, kh, kw, I, O)``  -> ``(O, I, kd, kh, kw)``; a
  ``ConvTranspose(transpose_kernel=True)`` ``(kd, kh, kw, O, I)`` -> torch's
  ``(I, O, kd, kh, kw)`` by the same transpose
- the ViT's patch-embedding Dense ``(p^3 C, E)`` (rows laid out ``(pz, py,
  px, c)``) -> Conv3d ``(E, C, p, p, p)``
- Dense ``(I, O)``               -> Linear ``(O, I)``, or ``(O, I, 1, 1)``
  for the decoder's 1x1-conv MLP
- LayerNorm / BatchNorm scale/bias -> weight/bias; BatchNorm
  ``batch_stats`` mean/var -> ``running_mean``/``running_var``
- GRN gamma/beta                 -> ``mlp.grn.weight``/``bias``
- ``DinoViT`` attention: q / k / v ``(E, heads, head_dim)`` -> Linear
  ``(E, E)`` (reshape, then transpose), the output ``(heads, head_dim, E)``
  -> ``(E, E)`` the same way; the patch conv ``(p, p, 3, E)`` -> ``(E, 3,
  p, p)``
- ConvNeXt-v1 ``ls_gamma``, the head's PReLU ``conv0_prelu`` -> ``gamma``,
  ``adn.A.weight`` (bare leaves)
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np
import torch
from torch import nn


def _conv2d(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def _conv3d(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (4, 3, 0, 1, 2))


def _linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _conv1x1(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))[:, :, None, None]


# (flax module path regex, torch module path template, kernel transform);
# a transform of None marks a norm (scale/bias), "grn" a GRN (gamma/beta)
Rule = tuple[str, str, Callable | str | None]


def _decoder_rules() -> list[Rule]:
    """UNeXt2Decoder: timm stages with 1x1-conv MLPs (FCMAE and UNeXt2)."""
    d, t = r"decoder/stage(\d+)/conv", "decoder.decoder_stages.{0}.conv"
    return [
        (rf"{d}/downsample_norm", f"{t}.downsample.0", None),
        (rf"{d}/downsample_conv", f"{t}.downsample.1", _conv2d),
        (rf"{d}/block(\d+)/dwconv", t + ".blocks.{1}.conv_dw", _conv2d),
        (rf"{d}/block(\d+)/norm", t + ".blocks.{1}.norm", None),
        (rf"{d}/block(\d+)/fc1", t + ".blocks.{1}.mlp.fc1", _conv1x1),
        (rf"{d}/block(\d+)/grn", t + ".blocks.{1}.mlp.grn", "grn"),
        (rf"{d}/block(\d+)/fc2", t + ".blocks.{1}.mlp.fc2", _conv1x1),
    ]


def _timm_encoder_rules(stem_norm: str, stages: str) -> list[Rule]:
    """A timm ConvNeXt encoder (``MultiscaleEncoder``): ``stem_norm`` and the
    stages' module path (``{0}`` the stage index) as the reference names
    them in its ``features_only`` (UNeXt2) or classification (contrastive)
    wrapping."""
    b = stages + ".blocks.{1}"
    return [
        (r"encoder/stem_norm", stem_norm, None),
        (r"encoder/stage(\d+)/downsample_norm", stages + ".downsample.0", None),
        (r"encoder/stage(\d+)/downsample_conv", stages + ".downsample.1", _conv2d),
        (r"encoder/stage(\d+)/block(\d+)/dwconv", b + ".conv_dw", _conv2d),
        (r"encoder/stage(\d+)/block(\d+)/norm", b + ".norm", None),
        (r"encoder/stage(\d+)/block(\d+)/fc1", b + ".mlp.fc1", _linear),
        (r"encoder/stage(\d+)/block(\d+)/grn", b + ".mlp.grn", "grn"),
        (r"encoder/stage(\d+)/block(\d+)/fc2", b + ".mlp.fc2", _linear),
    ]


# PixelToVoxelHead (MONAI Convolution: conv, then the PReLU's adn.A)
_HEAD_RULES: list[Rule] = [
    (r"head/conv0", "head.conv.0.conv", _conv3d),
    (r"head/conv1", "head.conv.1", _conv3d),
]

_FCMAE_RULES: list[Rule] = [
    (r"encoder/stem/conv3d", "encoder.stem.conv3d", _conv3d),
    (r"encoder/stem/conv2d", "encoder.stem.conv2d", _conv2d),
    (r"encoder/stem/norm", "encoder.stem.norm", None),
    (r"encoder/stage(\d+)/downsample_norm", "encoder.stages.{0}.downsample.0", None),
    (r"encoder/stage(\d+)/downsample_conv", "encoder.stages.{0}.downsample.1", _conv2d),
    (r"encoder/stage(\d+)/block(\d+)/dwconv", "encoder.stages.{0}.blocks.{1}.dwconv", _conv2d),
    (r"encoder/stage(\d+)/block(\d+)/norm", "encoder.stages.{0}.blocks.{1}.layernorm", None),
    (r"encoder/stage(\d+)/block(\d+)/fc1", "encoder.stages.{0}.blocks.{1}.mlp.fc1", _linear),
    (r"encoder/stage(\d+)/block(\d+)/grn", "encoder.stages.{0}.blocks.{1}.mlp.grn", "grn"),
    (r"encoder/stage(\d+)/block(\d+)/fc2", "encoder.stages.{0}.blocks.{1}.mlp.fc2", _linear),
    *_decoder_rules(),
    *_HEAD_RULES,
]

_UNEXT2_RULES: list[Rule] = [
    (r"stem/conv", "stem.conv", _conv3d),
    *_timm_encoder_rules("encoder_stages.stem_1", "encoder_stages.stages_{0}"),
    *_decoder_rules(),
    *_HEAD_RULES,
]

_CONTRASTIVE_RULES: list[Rule] = [
    (r"stem/conv", "stem.conv", _conv3d),
    *_timm_encoder_rules("encoder.stem.1", "encoder.stages.{0}"),
    # the reference erases timm's head.fc (encoder.py:122): only its norm
    (r"head_norm", "encoder.head.norm", None),
    (r"projection/fc0", "projection.0", _linear),
    (r"projection/bn0", "projection.1", None),
    (r"projection/fc1", "projection.3", _linear),
    (r"projection/bn1", "projection.4", None),
]

# flax's automatic names of ResNet3dEncoder -> the port's
_RESNET3D_RULES: list[Rule] = [
    (r"Conv_0", "stem_conv", _conv3d),
    (r"BatchNorm_0", "stem_bn", None),
    (r"layer(\d+)_(\d+)/Conv_0", "layers.{0}.{1}.conv1", _conv3d),
    (r"layer(\d+)_(\d+)/BatchNorm_0", "layers.{0}.{1}.bn1", None),
    (r"layer(\d+)_(\d+)/Conv_1", "layers.{0}.{1}.conv2", _conv3d),
    (r"layer(\d+)_(\d+)/BatchNorm_1", "layers.{0}.{1}.bn2", None),
    (r"layer(\d+)_(\d+)/Conv_2", "layers.{0}.{1}.proj_conv", _conv3d),
    (r"layer(\d+)_(\d+)/BatchNorm_2", "layers.{0}.{1}.proj_bn", None),
    (r"fc", "fc", _linear),
    (r"projection/fc0", "projection.0", _linear),
    (r"projection/bn0", "projection.1", None),
    (r"projection/fc1", "projection.3", _linear),
    (r"projection/bn1", "projection.4", None),
]


def _conv_block_rules(src: str, dst: str, conv: str, transform: Callable) -> list[Rule]:
    """A ``ConvBlock`` (flax ``conv{j}``, ``norm{j}/<Norm child>``,
    ``res_proj``) -> the reference's ``Conv{2,3}d_{j}``, ``batch_norm_{j}``,
    ``resid_conv``; ``src`` may hold groups, ``dst`` refers to them."""
    n = src.count("(")
    return [
        (rf"{src}/conv(\d+)", f"{dst}.{conv}_{{{n}}}", transform),
        (rf"{src}/norm(\d+)/(?:BatchNorm_0|GroupNorm_0)", f"{dst}.batch_norm_{{{n}}}", None),
        (rf"{src}/res_proj", f"{dst}.resid_conv", transform),
    ]


def _legacy_unet_rules(conv: str, transform: Callable) -> list[Rule]:
    """The legacy U-Nets' levels (flax ``{down,up}_conv_block{i}``,
    ``bottom_conv_block``, ``terminal_block``) -> the reference's
    ``{down,up}_conv_block_{i}``, ``bottom_transition_block`` (the 2-D
    model's bottom ConvBlock), ``terminal_block``."""
    return [
        *_conv_block_rules(r"(down|up)_conv_block(\d+)", "{0}_conv_block_{1}", conv, transform),
        *_conv_block_rules(r"bottom_conv_block", "bottom_transition_block", conv, transform),
        *_conv_block_rules(r"terminal_block", "terminal_block", conv, transform),
    ]


_UNET2D_RULES: list[Rule] = _legacy_unet_rules("Conv2d", _conv2d)
# the 2.5-D model's bottom transition is a bare (zk, 1, 1) conv
_UNET25D_RULES: list[Rule] = [
    *_legacy_unet_rules("Conv3d", _conv3d),
    (r"bottom_transition_block", "bottom_transition_block", _conv3d),
    (r"skip_conv_layer(\d+)", "skip_conv_layer_{0}", _conv3d),
]


def _unet3d_rules() -> list[Rule]:
    """``UNet3DBase`` (flax ``unet/...``) -> the reference torch names; the
    norms are the flax ``Norm`` wrapper's child (group or batch)."""

    def block(src: str, dst: str) -> list[Rule]:
        norm = r"/(?:GroupNorm_0|BatchNorm_0)"
        return [
            (rf"{src}/conv0", f"{dst}.block1.proj", _conv3d),
            (rf"{src}/norm0{norm}", f"{dst}.block1.norm", None),
            (rf"{src}/conv1", f"{dst}.block2.proj", _conv3d),
            (rf"{src}/norm1{norm}", f"{dst}.block2.norm", None),
            (rf"{src}/time_proj", f"{dst}.mlp.1", _linear),
            (rf"{src}/res_proj", f"{dst}.res_conv", _conv3d),
        ]

    return [
        (r"unet/inconv", "inconv", _conv3d),
        (r"unet/cond_inconv", "_cond_inconv", _conv3d),
        (r"unet/time_embedder/fc0", "_time_embedder.mlp.0", _linear),
        (r"unet/time_embedder/fc1", "_time_embedder.mlp.2", _linear),
        *block(r"unet/enc(\d+)_(\d+)", "_encoder_blocks.{0}.{1}"),
        (r"unet/down(\d+)", "_downsamples.{0}", _conv3d),
        *block(r"unet/dec(\d+)_(\d+)", "_decoder_blocks.{0}.{1}"),
        # the transposed kernel (k..., O, I) takes the conv's transpose to (I, O, k...)
        (r"unet/up(\d+)", "_upsamples.{0}", _conv3d),
        *block(r"unet/bottleneck/block", "bottleneck.block"),
        (r"unet/outconv", "outconv", _conv3d),
    ]


def _vit_rules(patch_size: int) -> list[Rule]:
    """``ViTBottleneck3D`` (flax ``unet/bottleneck/...``) -> the reference
    torch names."""

    def patch(w: np.ndarray) -> np.ndarray:
        e = w.shape[1]
        return np.transpose(w.reshape(patch_size, patch_size, patch_size, -1, e), (4, 3, 0, 1, 2))

    b, t = r"unet/bottleneck/block(\d+)", "bottleneck.blocks.{0}"
    return [
        (r"unet/bottleneck/patch_embed", "bottleneck.img_embedding.proj", patch),
        (rf"{b}/attn/attn_q", f"{t}.attn.to_q", _linear),
        (rf"{b}/attn/attn_k", f"{t}.attn.to_k", _linear),
        (rf"{b}/attn/attn_v", f"{t}.attn.to_v", _linear),
        (rf"{b}/attn/attn_out", f"{t}.attn.to_out.0", _linear),
        (rf"{b}/ff/ff_proj", f"{t}.ff.net.0.proj", _linear),
        (rf"{b}/ff/ff_out", f"{t}.ff.net.2", _linear),
        (rf"{b}/adaLN", f"{t}.adaLN.1", _linear),
        (r"unet/bottleneck/final_proj", "bottleneck.proj_out.linear", _linear),
        (r"unet/bottleneck/final_adaLN", "bottleneck.proj_out.adaLN.1", _linear),
    ]


# bare parameter leaves: (flax leaf path regex, torch key template): the
# head's PReLU slope and the ConvNeXt-v1 layer scale
_PRELU = (r"head/conv0_prelu", "head.conv.0.adn.A.weight")
_LAYER_SCALE = r"encoder/stage(\d+)/block(\d+)/ls_gamma"

_LEAF_NAMES = {
    None: {"scale": "weight", "bias": "bias"},
    "grn": {"gamma": "weight", "beta": "bias"},
}


def _leaves(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _bridge(
    tree: dict[str, Any], rules: list[Rule], bare: list[tuple[str, str]], what: str, stats: bool = False
) -> dict[str, torch.Tensor]:
    """Map a flax ``params`` (or, with ``stats``, ``batch_stats``) tree to
    float32 tensors under the torch names; ``KeyError`` on a leaf no rule
    covers."""
    out: dict[str, torch.Tensor] = {}
    for path, value in _leaves(tree):
        key = None
        for pattern, template in bare:
            m = re.fullmatch(pattern, path)
            if m is not None:
                key, value = template.format(*m.groups()), value.reshape(-1)
                break
        if key is None:
            module_path, leaf = path.rsplit("/", 1)
            for pattern, template, transform in rules:
                m = re.fullmatch(pattern, module_path)
                if m is None:
                    continue
                prefix = template.format(*m.groups())
                if stats:
                    names = {"mean": "running_mean", "var": "running_var"}
                    value = value.reshape(-1)
                elif callable(transform):
                    names = {"kernel": "weight", "bias": "bias"}
                    value = transform(value) if leaf == "kernel" else value.reshape(-1)
                else:
                    names = _LEAF_NAMES[transform]
                    value = value.reshape(-1)
                if leaf not in names:
                    raise KeyError(f"unexpected leaf {path!r}")
                key = f"{prefix}.{names[leaf]}"
                break
            else:
                raise KeyError(f"no {what} rule for flax {'batch statistic' if stats else 'parameter'} {path!r}")
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def fcmae_state_dict_from_flax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map a ``FullyConvolutionalMAE`` flax ``params`` tree (nested dicts of
    arrays; either head) to a float32 ``state_dict`` under the reference
    torch names.

    Raises ``KeyError`` on a leaf no rule covers. A tree without
    ``encoder/stem/conv2d`` (flax builds only the branch it runs) yields no
    ``encoder.stem.conv2d`` entries; :func:`load_flax_params` keeps that
    conv at its initialization.
    """
    return _bridge(params, _FCMAE_RULES, [_PRELU], "FCMAE")


def unext2_state_dict_from_flax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map a ``UNeXt2`` flax ``params`` tree to a float32 ``state_dict`` under
    the reference torch names (v1 backbones' layer scales included)."""
    return _bridge(params, _UNEXT2_RULES, [_PRELU, (_LAYER_SCALE, "encoder_stages.stages_{0}.blocks.{1}.gamma")],
                   "UNeXt2")


def contrastive_state_dict_from_flax(
    params: dict[str, Any], batch_stats: dict[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """Map a ``ContrastiveEncoder`` flax ``params`` tree, and its
    ``batch_stats`` (the projection's BatchNorm means and variances) when
    given, to a float32 ``state_dict`` under the reference torch names.
    ``num_batches_tracked`` has no flax counterpart and is not produced.
    The contrastive engine's auxiliary heads (``params["aux_heads"]``) map
    to ``aux_heads.<name>.<module path>``: a Dense ``kernel`` to its
    transposed ``weight``, a LayerNorm ``scale`` to ``weight``, other leaves
    (biases, the cosine classifier's ``weight`` and ``log_scale``) as they
    are."""
    params = dict(params)
    heads = params.pop("aux_heads", {})
    out = _bridge(params, _CONTRASTIVE_RULES, [(_LAYER_SCALE, "encoder.stages.{0}.blocks.{1}.gamma")],
                  "ContrastiveEncoder")
    for path, value in _leaves(heads):
        module_path, leaf = path.rsplit("/", 1)
        value = np.array(value, np.float32)
        if leaf == "kernel":
            leaf, value = "weight", value.T.copy()
        elif leaf == "scale":
            leaf = "weight"
        out[f"aux_heads.{module_path.replace('/', '.')}.{leaf}"] = torch.from_numpy(value)
    if batch_stats:
        out.update(_bridge(batch_stats, _CONTRASTIVE_RULES, [], "ContrastiveEncoder", stats=True))
    return out


def joint_encoder_state_dict_from_flax(
    params: dict[str, Any], batch_stats: dict[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """Map a ``JointEncoders`` flax tree (``params`` and, when given,
    ``batch_stats``: ``source_encoder`` and ``target_encoder`` subtrees) to the
    port's names: :func:`contrastive_state_dict_from_flax` of each encoder
    under ``source_encoder.`` / ``target_encoder.``, both projections'
    BatchNorm running statistics included."""
    out: dict[str, torch.Tensor] = {}
    for name in ("source_encoder", "target_encoder"):
        stats = (batch_stats or {}).get(name)
        for key, value in contrastive_state_dict_from_flax(params.get(name, {}), stats).items():
            out[f"{name}.{key}"] = value
    return out


def resnet3d_state_dict_from_flax(
    params: dict[str, Any], batch_stats: dict[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """Map a JAX ``ResNet3dEncoder`` flax tree (``params`` and optionally
    ``batch_stats``) to the port's ``ResNet3dEncoder`` state names."""
    out = _bridge(params, _RESNET3D_RULES, [], "ResNet3dEncoder")
    if batch_stats:
        out.update(_bridge(batch_stats, _RESNET3D_RULES, [], "ResNet3dEncoder", stats=True))
    return out


def celldiff_state_dict_from_flax(params: dict[str, Any], patch_size: int = 4) -> dict[str, torch.Tensor]:
    """Map a ``CELLDiffNet`` or ``UNetViT3D`` flax ``params`` tree (the 3-D
    U-Net base with group norms and the ViT bottleneck of ``patch_size``)
    to a float32 ``state_dict`` under the reference torch names. The
    reference's fixed ``_time_embedder.freqs`` and ``img_pos_embed`` buffers
    are not produced: the port recomputes them, as the JAX package does."""
    return _bridge(params, _vit_rules(patch_size) + _unet3d_rules(), [], "CELLDiff")


def unet3d_state_dict_from_flax(
    params: dict[str, Any], batch_stats: dict[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """Map a ``Unet3d`` (FNet3D) flax ``params`` tree, and its
    ``batch_stats`` (the BatchNorms' means and variances) when given, to a
    float32 ``state_dict`` under the reference torch names
    (``num_batches_tracked`` has no flax counterpart and is not produced)."""
    out = _bridge(params, _unet3d_rules(), [], "Unet3d")
    if batch_stats:
        out.update(_bridge(batch_stats, _unet3d_rules(), [], "Unet3d", stats=True))
    return out


def unet2d_state_dict_from_flax(
    params: dict[str, Any], batch_stats: dict[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """Map a ``Unet2d`` flax ``params`` tree, and its ``batch_stats`` when
    given, to a float32 ``state_dict`` under the reference torch names (the
    names ``viscy_tpu.training.convert.convert_unet2d_state_dict`` reads:
    flax ``bottom_conv_block`` is the reference's ``bottom_transition_block``;
    ``num_batches_tracked`` is not produced)."""
    out = _bridge(params, _UNET2D_RULES, [], "Unet2d")
    if batch_stats:
        out.update(_bridge(batch_stats, _UNET2D_RULES, [], "Unet2d", stats=True))
    return out


def unet25d_state_dict_from_flax(
    params: dict[str, Any], batch_stats: dict[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """Map a ``Unet25d`` flax ``params`` tree, and its ``batch_stats`` when
    given, to a float32 ``state_dict`` under the reference torch names (those
    ``convert_unet25d_state_dict`` reads)."""
    out = _bridge(params, _UNET25D_RULES, [], "Unet25d")
    if batch_stats:
        out.update(_bridge(batch_stats, _UNET25D_RULES, [], "Unet25d", stats=True))
    return out


def patchgan_state_dict_from_flax(
    params: dict[str, Any], batch_stats: dict[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """Map a ``MultiScalePatchGAN3D`` flax ``params`` tree (``scale{s}/
    conv{i}``, ``norm{i}``, ``conv_out``), and its spectral-norm
    ``batch_stats`` (``scale{s}/SpectralNorm_{k}/<conv>/kernel/{u,sigma}``)
    when given, to the port's names: ``discriminators.{s}.layer{i}.0``
    (conv; ``u`` (1, C_out) and ``sigma`` buffers), ``.layer{i}.1``
    (instance norm) and ``layer{n+1}`` (the logit conv), as the reference
    (``viscy_tpu.training.convert``'s ``_PATCHGAN3D_RULES``) names them."""
    out: dict[str, torch.Tensor] = {}
    for scale, tree in params.items():
        s = int(re.fullmatch(r"scale(\d+)", scale).group(1))
        n = sum(1 for k in tree if re.fullmatch(r"conv\d+", k))
        rules: list[Rule] = [
            (r"conv(\d+)", f"discriminators.{s}.layer{{0}}.0", _conv3d),
            (r"norm(\d+)", f"discriminators.{s}.layer{{0}}.1", None),
            (r"conv_out", f"discriminators.{s}.layer{n + 1}", _conv3d),
        ]
        out.update(_bridge(tree, rules, [], "PatchGAN3D"))
        for path, value in _leaves((batch_stats or {}).get(scale, {})):
            m = re.fullmatch(r"SpectralNorm_\d+/(conv\d+|conv_out)/kernel/(u|sigma)", path)
            if m is None:
                raise KeyError(f"no PatchGAN3D rule for flax batch statistic {path!r}")
            conv, leaf = m.groups()
            layer = f"layer{n + 1}" if conv == "conv_out" else f"layer{conv[4:]}.0"
            out[f"discriminators.{s}.{layer}.{leaf}"] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def gan_state_dict_from_flax(generator: nn.Module, variables: dict[str, Any]) -> dict[str, Any]:
    """Map the JAX ``DynacellGAN``'s variables (``params/{generator,
    discriminator}``, ``batch_stats/discriminator``, ``gan_state``) to the
    port engine's state: ``{"model": the generator's state_dict (through the
    bridge of ``generator``'s type), "discriminator": the discriminator's
    (the ``u`` and ``sigma`` vectors included), "ema_generator": the EMA
    tree through the generator's bridge (None without one), "gan_state":
    {"d_step": int, "lecam_real", "lecam_fake": 0-d float32}}``, the layout
    ``DynacellGAN.load_checkpoint_state`` takes."""
    params = variables["params"]
    state = variables.get("gan_state", {})
    ema = state.get("ema_generator")
    return {
        "model": state_dict_from_flax(generator, params["generator"]),
        "discriminator": patchgan_state_dict_from_flax(params["discriminator"],
                                                       variables.get("batch_stats", {}).get("discriminator")),
        "ema_generator": None if ema is None else state_dict_from_flax(generator, ema),
        "gan_state": {"d_step": int(np.asarray(state.get("d_step", 0))),
                      **{k: torch.tensor(float(np.asarray(state.get(k, 0.0))), dtype=torch.float32)
                         for k in ("lecam_real", "lecam_fake")}},
    }


def _convnext_stage_rules(src: str, dst: str) -> list[Rule]:
    """A ``ConvNeXtStage`` with dense fc1 / fc2 (flax ``downsample_*``,
    ``block{j}/...``) -> the port's ``ConvNeXtStage`` names; ``src`` holds
    one group, ``dst`` refers to it."""
    return [
        (rf"{src}/downsample_norm", f"{dst}.downsample.0", None),
        (rf"{src}/downsample_conv", f"{dst}.downsample.1", _conv2d),
        (rf"{src}/block(\d+)/dwconv", dst + ".blocks.{1}.conv_dw", _conv2d),
        (rf"{src}/block(\d+)/norm", dst + ".blocks.{1}.norm", None),
        (rf"{src}/block(\d+)/fc1", dst + ".blocks.{1}.mlp.fc1", _linear),
        (rf"{src}/block(\d+)/grn", dst + ".blocks.{1}.mlp.grn", "grn"),
        (rf"{src}/block(\d+)/fc2", dst + ".blocks.{1}.mlp.fc2", _linear),
    ]


_BETA_VAE_25D_RULES: list[Rule] = [
    (r"stem/conv", "stem.conv", _conv3d),
    *_timm_encoder_rules("encoder.stem_1", "encoder.stages_{0}"),
    (r"fc_(mean|logvar|decode)", "fc_{0}", _linear),
    *_convnext_stage_rules(r"up(\d+)/conv", "up{0}.conv"),
    *_HEAD_RULES,
]


def _flax_named(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A flax tree under its own names: ``a/b/kernel`` -> ``a.b.weight``
    (transposed to torch's layout by its rank: dense, 2-D or 3-D conv,
    transposed-conv kernels as stored), other leaves as they are (a PReLU's
    ``prelu`` (1,))."""
    out = {}
    for path, value in _leaves(params):
        module_path, leaf = path.rsplit("/", 1)
        key = module_path.replace("/", ".")
        if leaf == "kernel":
            value = {2: _linear, 4: _conv2d, 5: _conv3d}[value.ndim](value)
            leaf = "weight"
        out[f"{key}.{leaf}"] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def vae_state_dict_from_flax(model: nn.Module, params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map a VAE's flax ``params`` to the port model's state_dict. The JAX
    package has no VAE converter, so: a ``BetaVae25D``'s stem, encoder (timm
    ``features_only`` names, v1 layer scales included) and head take the
    port's names for those parts elsewhere, the rest (``fc_*``,
    ``up{i}/conv`` as the port's ``ConvNeXtStage``) the flax tree's; a
    ``BetaVaeConv``'s every name is the flax tree's (``.``-joined, kernels
    as ``weight`` in torch's layout)."""
    from viscy_tpu_torch.models.vae import BetaVae25D, BetaVaeConv

    if isinstance(model, BetaVae25D):
        return _bridge(params, _BETA_VAE_25D_RULES, [_PRELU, (_LAYER_SCALE, "encoder.stages_{0}.blocks.{1}.gamma")],
                       "BetaVae25D")
    if isinstance(model, BetaVaeConv):
        return _flax_named(params)
    raise TypeError(f"no flax -> torch VAE bridge for a {type(model).__name__}")



def _heads_in(w: np.ndarray) -> np.ndarray:
    """flax attention q / k / v kernel ``(E, heads, head_dim)`` -> Linear ``(E, E)``."""
    return np.transpose(w.reshape(w.shape[0], -1), (1, 0))


def _heads_out(w: np.ndarray) -> np.ndarray:
    """flax attention output kernel ``(heads, head_dim, E)`` -> Linear ``(E, E)``."""
    return np.transpose(w.reshape(-1, w.shape[-1]), (1, 0))


def _dinovit_rules(prefix: str) -> tuple[list[Rule], list[tuple[str, str]]]:
    b, t = r"block(\d+)", prefix + "encoder.layer.{0}"
    rules: list[Rule] = [
        (r"patch_embed", prefix + "embeddings.patch_embeddings.projection", _conv2d),
        (r"norm", prefix + "layernorm", None),
        (rf"{b}/norm1", f"{t}.norm1", None),
        (rf"{b}/norm2", f"{t}.norm2", None),
        (rf"{b}/attn/(query|key|value)", t + ".attention.attention.{1}", _heads_in),
        (rf"{b}/attn/out", f"{t}.attention.output.dense", _heads_out),
        (rf"{b}/fc1", f"{t}.mlp.fc1", _linear),
        (rf"{b}/fc2", f"{t}.mlp.fc2", _linear),
    ]
    bare = [(rf"{b}/ls1", t + ".layer_scale1.lambda1"), (rf"{b}/ls2", t + ".layer_scale2.lambda1")]
    return rules, bare


def dinovit_state_dict_from_flax(params: dict[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """Map a flax ``DinoViT`` ``params`` tree to the port's ``DinoViT``
    state dict (HF ``Dinov2Model`` names), each key under ``prefix``."""
    params = dict(params)
    out = {prefix + "embeddings.cls_token": torch.from_numpy(np.array(params.pop("cls_token"), np.float32)),
           prefix + "embeddings.position_embeddings": torch.from_numpy(np.array(params.pop("pos_embed"),
                                                                               np.float32))}
    out.update(_bridge(params, *_dinovit_rules(prefix), "DinoViT"))
    return out


def foundation_state_dict_from_flax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map the flax ``params`` of a foundation wrapper (``DINOv3Model``,
    ``CellDinoModel``, ``OpenPhenomModel``: the ``backbone`` subtree, and a
    Dense ``projection`` when it has one) to the port wrapper's state dict."""
    params = dict(params)
    out = dinovit_state_dict_from_flax(params.pop("backbone"), "backbone.")
    if "projection" in params:
        out.update(_bridge({"projection": params.pop("projection")},
                           [(r"projection", "projection", _linear)], [], "projection"))
    if params:
        raise KeyError(f"no foundation-wrapper rule for flax parameters {sorted(params)}")
    return out


_MLP_RULES: list[Rule] = [
    (r"(fc\d+|fc_out|head)", "{0}", _linear),
    (r"(norm\d+|norm_out)", "{0}", None),
]


def mlp_state_dict_from_flax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map the flax ``MLP`` head's ``params`` (``norm="ln"``; dense
    ``fc{i}`` / ``fc_out`` / ``head``, LayerNorm ``norm{i}`` / ``norm_out``)
    to the port's :class:`~viscy_tpu_torch.models.components.heads.MLP`
    state_dict (a linear head; a cosine head's names differ and raise)."""
    return _bridge(params, _MLP_RULES, [], "MLP")


def linear_pipeline_from_jax(pipeline, device: str = "cuda"):
    """The port's :class:`~viscy_tpu_torch.evaluation.linear_classifier.
    LinearClassifierPipeline` from a loaded JAX ``LinearClassifierPipeline``
    (run where sklearn is installed, then ``save`` the result): the scaler's
    ``mean_`` and ``scale_``, the classifier's ``coef_``, ``intercept_`` and
    ``classes_``, and the optional PCA's ``components_`` and ``mean_``, all
    read as numpy arrays, and the ``task`` the dataset-level probe sets. A
    liblinear classifier's ``intercept_`` already carries its
    ``intercept_scaling``, and a PCA's ``transform`` (``whiten=False``) is
    ``(x - mean_) @ components_.T``, as the port applies it."""
    from viscy_tpu_torch.evaluation.linear_classifier import LinearClassifierPipeline

    scaler, clf, pca = pipeline.scaler, pipeline.classifier, getattr(pipeline, "pca", None)
    if pca is not None and getattr(pca, "whiten", False):
        raise NotImplementedError("a whitened PCA in a JAX pipeline is not carried across (the port's pipeline "
                                  "projects without whitening)")
    port = LinearClassifierPipeline(
        None if scaler is None else np.asarray(scaler.mean_), None if scaler is None else np.asarray(scaler.scale_),
        np.asarray(clf.coef_), np.asarray(clf.intercept_), np.asarray(clf.classes_),
        None if pca is None else np.asarray(pca.components_), None if pca is None else np.asarray(pca.mean_),
        device=device)
    if hasattr(pipeline, "task"):
        port.task = pipeline.task
    return port


def state_dict_from_flax(
    model: nn.Module, params: dict[str, Any], batch_stats: dict[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """The bridge of ``model``'s type applied to a flax tree; ``TypeError``
    naming the type when no bridge maps it."""
    from viscy_tpu_torch.apps.dynaclr.multi_modal import JointEncoders
    from viscy_tpu_torch.models.celldiff.vit_bottleneck import ViTBottleneck3D
    from viscy_tpu_torch.models.components.heads import MLP
    from viscy_tpu_torch.models.contrastive.encoder import ContrastiveEncoder
    from viscy_tpu_torch.models.contrastive.resnet3d import ResNet3dEncoder
    from viscy_tpu_torch.models.foundation.vit import DinoViT
    from viscy_tpu_torch.models.foundation.wrappers import _FrozenViTWrapper
    from viscy_tpu_torch.models.unet.fcmae import FullyConvolutionalMAE
    from viscy_tpu_torch.models.unet.unet2d import Unet2d
    from viscy_tpu_torch.models.unet.unet25d import Unet25d
    from viscy_tpu_torch.models.unet.unet3d import Unet3d
    from viscy_tpu_torch.models.unet.unet3d_base import UNet3DBase
    from viscy_tpu_torch.models.unet.unext2 import UNeXt2

    from viscy_tpu_torch.models.vae import BetaVae25D, BetaVaeConv

    if isinstance(model, (BetaVae25D, BetaVaeConv)) and not batch_stats:
        return vae_state_dict_from_flax(model, params)
    if isinstance(model, MLP) and not batch_stats:
        return mlp_state_dict_from_flax(params)
    if isinstance(model, Unet2d):
        return unet2d_state_dict_from_flax(params, batch_stats)
    if isinstance(model, Unet25d):
        return unet25d_state_dict_from_flax(params, batch_stats)
    if isinstance(model, ContrastiveEncoder):
        return contrastive_state_dict_from_flax(params, batch_stats)
    if isinstance(model, JointEncoders):
        return joint_encoder_state_dict_from_flax(params, batch_stats)
    if isinstance(model, ResNet3dEncoder):
        return resnet3d_state_dict_from_flax(params, batch_stats)
    if isinstance(model, Unet3d):
        return unet3d_state_dict_from_flax(params, batch_stats)
    if batch_stats:
        raise ValueError(f"{type(model).__name__} has no batch statistics")
    if isinstance(model, UNet3DBase) and isinstance(model.bottleneck, ViTBottleneck3D):
        return celldiff_state_dict_from_flax(params, model.bottleneck.patch_size)
    if isinstance(model, UNeXt2):
        return unext2_state_dict_from_flax(params)
    if isinstance(model, DinoViT):
        return dinovit_state_dict_from_flax(params)
    if isinstance(model, _FrozenViTWrapper):
        return foundation_state_dict_from_flax(params)
    if isinstance(model, FullyConvolutionalMAE):
        return fcmae_state_dict_from_flax(params)
    raise TypeError(f"no flax -> torch bridge for a {type(model).__name__}")


def load_flax_params(model: nn.Module, params: dict[str, Any], batch_stats: dict[str, Any] | None = None) -> None:
    """Load a flax ``params`` tree (and ``batch_stats``) into ``model`` through
    the bridge of its type (strict: every converted key must exist with its
    shape; entries the tree lacks keep their values)."""
    state = model.state_dict()
    for key, value in state_dict_from_flax(model, params, batch_stats).items():
        if key not in state:
            raise KeyError(f"converted key {key!r} not in the model")
        if tuple(state[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: model {tuple(state[key].shape)} vs converted {tuple(value.shape)}")
        state[key] = value
    model.load_state_dict(state, strict=True)
