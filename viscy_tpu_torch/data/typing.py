"""Sample and index types of the HCS and triplet data paths (the part of
``viscy_tpu/data/typing.py`` the port's datamodule uses)."""

from __future__ import annotations

from typing import NamedTuple, Sequence, TypedDict, Union


class HCSStackIndex(NamedTuple):
    """(image array path, time index, z index) of a sliding window."""

    image: str
    time: int
    z: int


class ChannelMap(TypedDict, total=False):
    """Source and target channel names."""

    source: Union[str, Sequence[str]]
    target: Union[str, Sequence[str]]


# the tracking columns a predict batch's ``index`` carries, in this order
ULTRACK_INDEX_COLUMNS = [
    "fov_name",
    "track_id",
    "t",
    "id",
    "parent_track_id",
    "parent_id",
    "z",
    "y",
    "x",
]
