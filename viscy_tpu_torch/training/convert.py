"""flax parameter tree -> reference VisCy torch ``state_dict`` (the inverse
of ``viscy_tpu/training/convert.py``'s ``_FCMAE_RULES``).

The port's models carry the reference torch names and layouts, so weights
cross between the two packages through this bridge one way and
``viscy_tpu.training.convert.convert_fcmae_state_dict`` the other. The
rules are the port's own copy.

Layout transposes (flax -> torch):

- Conv2d ``(kh, kw, I, O)``      -> ``(O, I, kh, kw)`` (depthwise included)
- Conv3d ``(kd, kh, kw, I, O)``  -> ``(O, I, kd, kh, kw)``
- Dense ``(I, O)``               -> Linear ``(O, I)``, or ``(O, I, 1, 1)``
  for the decoder's 1x1-conv MLP
- LayerNorm scale/bias           -> weight/bias
- GRN gamma/beta                 -> ``mlp.grn.weight``/``bias``
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
_FCMAE_RULES: list[tuple[str, str, Callable | str | None]] = [
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
    (
        r"decoder/stage(\d+)/conv/downsample_norm",
        "decoder.decoder_stages.{0}.conv.downsample.0",
        None,
    ),
    (
        r"decoder/stage(\d+)/conv/downsample_conv",
        "decoder.decoder_stages.{0}.conv.downsample.1",
        _conv2d,
    ),
    (
        r"decoder/stage(\d+)/conv/block(\d+)/dwconv",
        "decoder.decoder_stages.{0}.conv.blocks.{1}.conv_dw",
        _conv2d,
    ),
    (
        r"decoder/stage(\d+)/conv/block(\d+)/norm",
        "decoder.decoder_stages.{0}.conv.blocks.{1}.norm",
        None,
    ),
    (
        r"decoder/stage(\d+)/conv/block(\d+)/fc1",
        "decoder.decoder_stages.{0}.conv.blocks.{1}.mlp.fc1",
        _conv1x1,
    ),
    (
        r"decoder/stage(\d+)/conv/block(\d+)/grn",
        "decoder.decoder_stages.{0}.conv.blocks.{1}.mlp.grn",
        "grn",
    ),
    (
        r"decoder/stage(\d+)/conv/block(\d+)/fc2",
        "decoder.decoder_stages.{0}.conv.blocks.{1}.mlp.fc2",
        _conv1x1,
    ),
]

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


def fcmae_state_dict_from_flax(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map a ``FullyConvolutionalMAE`` flax ``params`` tree (nested dicts of
    arrays) to a float32 ``state_dict`` under the reference torch names.

    Raises ``KeyError`` on a leaf no rule covers. A tree without
    ``encoder/stem/conv2d`` (flax builds only the branch it runs) yields no
    ``encoder.stem.conv2d`` entries; :func:`load_flax_params` keeps that
    conv at its initialization.
    """
    out: dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        module_path, leaf = path.rsplit("/", 1)
        for pattern, template, transform in _FCMAE_RULES:
            m = re.fullmatch(pattern, module_path)
            if m is None:
                continue
            prefix = template.format(*m.groups())
            if callable(transform):
                names = {"kernel": "weight", "bias": "bias"}
                value = transform(value) if leaf == "kernel" else value.reshape(-1)
            else:
                names = _LEAF_NAMES[transform]
                value = value.reshape(-1)
            if leaf not in names:
                raise KeyError(f"unexpected leaf {path!r}")
            out[f"{prefix}.{names[leaf]}"] = torch.from_numpy(
                np.ascontiguousarray(value, dtype=np.float32)
            )
            break
        else:
            raise KeyError(f"no FCMAE rule for flax parameter {path!r}")
    return out


def load_flax_params(model: nn.Module, params: dict[str, Any]) -> None:
    """Load a flax ``params`` tree into ``model`` (strict: every converted
    key must exist with its shape; entries the tree lacks keep their values)."""
    state = model.state_dict()
    for key, value in fcmae_state_dict_from_flax(params).items():
        if key not in state:
            raise KeyError(f"converted key {key!r} not in the model")
        if tuple(state[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: model {tuple(state[key].shape)} vs converted {tuple(value.shape)}")
        state[key] = value
    model.load_state_dict(state, strict=True)
