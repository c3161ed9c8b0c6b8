"""Device resolution for the port's entry points: explicit, no fallback."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate ``device`` and return it as a ``torch.device``.

    ``"cuda"`` resolves to the current CUDA device and raises when no card
    is visible: a caller that wants the CPU asks for ``"cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    count = torch.cuda.device_count()
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.index >= count:
        raise RuntimeError(f"device {dev} requested but only {count} CUDA device(s) visible")
    return dev
