"""Hugging Face DINOv2 checkpoints -> :class:`DinoViT` state dicts
(counterpart of ``viscy_tpu/models/foundation/convert.py``).

The port's ``DinoViT`` carries the names and layouts of HF's
``Dinov2Model``, so conversion keeps the backbone's keys as they are, drops
the masked-image token (``embeddings.mask_token``, unused at inference) and
refuses anything else by name. Checkpoints are read from local files only:
a ``.bin`` through ``torch.load(weights_only=True)`` and a
``.safetensors`` file through the reader below (neither ``safetensors`` nor
``transformers`` is needed).
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

__all__ = ["convert_dinov2_state_dict", "load_dinov2_checkpoint", "read_safetensors"]

_DROPPED = {"embeddings.mask_token"}
_GLOBAL = {
    "embeddings.cls_token",
    "embeddings.position_embeddings",
    "embeddings.patch_embeddings.projection.weight",
    "embeddings.patch_embeddings.projection.bias",
    "layernorm.weight",
    "layernorm.bias",
}
_LAYER = re.compile(
    r"encoder\.layer\.(\d+)\.(norm1|norm2|attention\.attention\.(?:query|key|value)|attention\.output\.dense"
    r"|mlp\.fc1|mlp\.fc2)\.(weight|bias)$|encoder\.layer\.(\d+)\.layer_scale[12]\.lambda1$"
)

# safetensors dtype names -> numpy little-endian dtypes (BF16 is read as raw
# 16-bit words and widened)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
              "U8": "u1", "BOOL": "?", "BF16": "<u2"}


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def convert_dinov2_state_dict(sd: Mapping[str, "torch.Tensor | np.ndarray"], depth: int,
                              num_heads: int) -> dict[str, torch.Tensor]:
    """The backbone keys of an HF ``Dinov2Model`` state dict, as
    :class:`DinoViT` loads them. Raises ``ValueError`` when the checkpoint's
    depth is not ``depth`` or its width is not a multiple of ``num_heads``,
    ``KeyError`` naming keys that are missing or unknown (a DINOv2-with-
    registers or DINOv3 checkpoint, a SwiGLU MLP, a classification head)."""
    sd = {k[len("dinov2."):] if k.startswith("dinov2.") else k: v for k, v in sd.items()}
    unknown = sorted(k for k in sd if k not in _DROPPED and k not in _GLOBAL and not _LAYER.match(k))
    if unknown:
        raise KeyError(f"not keys of a DINOv2 backbone: {unknown[:8]}{' ...' if len(unknown) > 8 else ''}")
    missing = sorted(_GLOBAL - set(sd))
    if missing:
        raise KeyError(f"missing DINOv2 keys: {missing}")
    layers = {int(m.group(1) or m.group(4)) for m in map(_LAYER.match, sd) if m}
    if layers != set(range(depth)):
        raise ValueError(f"checkpoint has {len(layers)} layers ({sorted(layers)[:3]}...), expected depth {depth}")
    embed_dim = sd["embeddings.cls_token"].shape[-1]
    if embed_dim % num_heads:
        raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
    return {k: _tensor(v) for k, v in sd.items() if k not in _DROPPED}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file: an 8-byte little-endian header length, a JSON
    header (``dtype``, ``shape``, ``data_offsets`` per tensor, an optional
    ``__metadata__``), then the raw little-endian tensor bytes."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8 : 8 + n])
    body = memoryview(raw)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, which this reader does not read")
        start, end = info["data_offsets"]
        arr = np.frombuffer(body[start:end], dtype=_ST_DTYPES[dtype]).reshape(info["shape"]).copy()
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if dtype == "BF16" else t
    return out


def load_dinov2_checkpoint(path: str | Path, depth: int, num_heads: int) -> dict[str, torch.Tensor]:
    """Convert a local HF checkpoint: a ``.safetensors`` or ``.bin`` file, or
    a directory holding ``model.safetensors`` or ``pytorch_model.bin``.
    Nothing is fetched."""
    path = Path(path)
    if path.is_dir():
        for name in ("model.safetensors", "pytorch_model.bin"):
            if (path / name).is_file():
                path = path / name
                break
        else:
            raise FileNotFoundError(f"{path} holds neither model.safetensors nor pytorch_model.bin")
    if path.suffix == ".safetensors":
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_dinov2_state_dict(sd, depth=depth, num_heads=num_heads)
