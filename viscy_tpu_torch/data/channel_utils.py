"""Microscopy channel-name parsing (counterpart of
``viscy_tpu/data/channel_utils.py``; reference
``viscy_data/channel_utils.py``): labels such as ``"raw GFP EX488
EM525-45"`` become structured metadata."""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["ChannelMetadata", "parse_channel_name"]


@dataclass
class ChannelMetadata:
    raw_name: str
    fluorophore: str | None = None
    excitation_nm: float | None = None
    emission_nm: float | None = None
    emission_bandwidth_nm: float | None = None
    is_label_free: bool = False
    modality: str | None = None


_LABEL_FREE = {"phase", "phase3d", "retardance", "brightfield", "bf", "dic", "zernike"}
_FLUOROPHORES = {
    "gfp", "rfp", "yfp", "cfp", "mcherry", "dapi", "hoechst", "tomato",
    "venus", "citrine", "tagbfp", "mscarlet", "mneongreen",
}


def parse_channel_name(name: str) -> ChannelMetadata:
    """Parse a channel label: whitespace- or underscore-separated tokens,
    each a label-free modality, a fluorophore, ``EX<nm>`` or
    ``EM<nm>[-<bandwidth>]`` (case-insensitive); a fluorophore without a
    modality makes the modality ``"fluorescence"``."""
    meta = ChannelMetadata(raw_name=name)
    for tok in re.split(r"[\s_]+", name.strip()):
        low = tok.lower()
        if low in _LABEL_FREE:
            meta.is_label_free = True
            meta.modality = low
        elif low in _FLUOROPHORES:
            meta.fluorophore = tok
        elif m := re.fullmatch(r"ex(\d+(?:\.\d+)?)", low):
            meta.excitation_nm = float(m.group(1))
        elif m := re.fullmatch(r"em(\d+(?:\.\d+)?)(?:-(\d+(?:\.\d+)?))?", low):
            meta.emission_nm = float(m.group(1))
            if m.group(2):
                meta.emission_bandwidth_nm = float(m.group(2))
    if meta.fluorophore and not meta.modality:
        meta.modality = "fluorescence"
    return meta
