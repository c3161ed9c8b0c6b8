"""Schedules (counterpart of ``viscy_tpu/models/schedule.py``; reference
``viscy_models/schedule.py``)."""

from __future__ import annotations

import math


def cosine_anneal(start: float, end: float, step: int, total_steps: int) -> float:
    """Cosine annealing from ``start`` to ``end`` over ``total_steps``
    (``end`` from ``total_steps`` on), in the JAX package's order of
    operations."""
    if total_steps <= 0 or step >= total_steps:
        return end
    cos = 0.5 * (1 + math.cos(math.pi * step / total_steps))
    return end + (start - end) * cos
