"""Whole-channel dropout for bag-of-channels training (counterpart of
``viscy_tpu/data/channel_dropout.py``; reference
``viscy_data/channel_dropout.py``)."""

from __future__ import annotations

import torch

from viscy_tpu_torch.transforms.base import RandTransform

__all__ = ["ChannelDropout"]


class ChannelDropout(RandTransform):
    """Zero whole channels of each sample with probability ``dropout_prob``,
    never all of them: one channel per sample, drawn at random, is always
    kept (whether or not every channel drew a drop).

    Draws, per key: ``{"drop_uniform": (B, C) uniform [0, 1), "keep_idx":
    (B,) int}``; a channel drops where ``drop_uniform < dropout_prob`` and
    it is not ``keep_idx``."""

    is_spatial = False

    def __init__(self, keys: str | list[str] = "anchor", dropout_prob: float = 0.2,
                 allow_missing_keys: bool = True) -> None:
        super().__init__(keys, 1.0, allow_missing_keys)
        self.dropout_prob = dropout_prob

    def draw(self, data: dict, generator: torch.Generator) -> dict:
        out = {}
        for k in self.key_iterator(data):
            b, c = data[k].shape[:2]
            dev = data[k].device
            out[k] = {"drop_uniform": torch.rand((b, c), generator=generator, device=dev),
                      "keep_idx": torch.randint(0, c, (b,), generator=generator, device=dev)}
        return out

    def apply(self, data: dict, draws: dict) -> dict:
        for k in self.key_iterator(data):
            x = data[k]
            b, c = x.shape[:2]
            d = draws[k]
            drop = torch.as_tensor(d["drop_uniform"], device=x.device) < self.dropout_prob
            keep = torch.nn.functional.one_hot(torch.as_tensor(d["keep_idx"], device=x.device).long(), c).bool()
            mask = (~(drop & ~keep)).to(x.dtype).reshape(b, c, *([1] * (x.ndim - 2)))
            data[k] = x * mask
        return data
