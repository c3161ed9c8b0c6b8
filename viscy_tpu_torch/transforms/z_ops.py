"""Z-axis transforms and stack utilities (counterpart of
``viscy_tpu/transforms/z_ops.py``): channel-wise Z reduction (MIP or the
center slice), channel stacking and decollation."""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from viscy_tpu_torch.transforms.base import MapTransform, Transform

__all__ = [
    "BatchedChannelWiseZReduction",
    "BatchedChannelWiseZReductiond",
    "StackChannelsd",
    "BatchedStackChannelsd",
    "Decollated",
]


class BatchedChannelWiseZReduction(Transform):
    """Reduce Z of a (B, C, Z, Y, X) batch to one slice: the maximum
    intensity projection or the center slice ``Z // 2``; with a per-sample
    ``is_labelfree`` mask, the center slice where it is set and the MIP
    elsewhere."""

    is_spatial = True
    changes_shape = True

    def __init__(self, default_strategy: str = "mip") -> None:
        if default_strategy not in ("mip", "center"):
            raise ValueError(f"default_strategy must be 'mip' or 'center', got {default_strategy!r}")
        self.default_strategy = default_strategy

    def __call__(self, img: torch.Tensor, is_labelfree: torch.Tensor | None = None) -> torch.Tensor:
        z = img.shape[2]
        center = img[:, :, z // 2 : z // 2 + 1]
        if is_labelfree is None and self.default_strategy == "center":
            return center
        mip = img.amax(dim=2, keepdim=True)
        if is_labelfree is None:
            return mip
        sel = torch.as_tensor(is_labelfree, device=img.device).reshape((-1,) + (1,) * (img.ndim - 1))
        return torch.where(sel.bool(), center, mip)


class BatchedChannelWiseZReductiond(MapTransform):
    """Dict version; reads the per-sample mask from ``labelfree_key`` when
    it is set and present."""

    is_spatial = True
    changes_shape = True

    def __init__(
        self,
        keys: str | Iterable[str],
        default_strategy: str = "mip",
        labelfree_key: str | None = None,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.reduce = BatchedChannelWiseZReduction(default_strategy)
        self.labelfree_key = labelfree_key

    def __call__(self, data: dict) -> dict:
        data = dict(data)
        mask = data.get(self.labelfree_key) if self.labelfree_key else None
        for k in self.key_iterator(data):
            data[k] = self.reduce(data[k], mask)
        return data


def _concatenate(arrays: list, axis: int):
    if isinstance(arrays[0], torch.Tensor):
        return torch.cat(arrays, dim=axis)
    return np.concatenate(arrays, axis=axis)


class StackChannelsd(MapTransform):
    """Collapse per-channel keys into stacked arrays:
    ``StackChannelsd(source=["Phase"], target=["Nuclei", "Membrane"])``
    concatenates single-channel (1, Z, Y, X) entries along the channel
    axis into ``source`` and ``target`` (tensors or numpy arrays)."""

    is_spatial = False
    _axis = 0

    def __init__(self, **groups: Sequence[str]) -> None:
        super().__init__([k for ks in groups.values() for k in ks])
        self.groups = {name: list(ks) for name, ks in groups.items()}

    def __call__(self, data: dict) -> dict:
        data = dict(data)
        for name, ks in self.groups.items():
            data[name] = _concatenate([data[k] for k in ks], self._axis)
        return data


class BatchedStackChannelsd(StackChannelsd):
    """Batched variant: stacks (B, 1, Z, Y, X) channel keys along C."""

    _axis = 1


class Decollated(Transform):
    """Split a batched sample dict into a list of per-sample dicts (the
    given ``keys``, else every value with a leading dimension)."""

    def __init__(self, keys: str | Iterable[str] | None = None) -> None:
        self.keys = keys

    def __call__(self, data: dict) -> list[dict]:
        if isinstance(self.keys, str):
            keys = [self.keys]
        elif self.keys:
            keys = list(self.keys)
        else:
            keys = [k for k, v in data.items() if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0]
        out = []
        for i in range(data[keys[0]].shape[0]):
            item = dict(data)
            for k in keys:
                item[k] = data[k][i]
            out.append(item)
        return out
