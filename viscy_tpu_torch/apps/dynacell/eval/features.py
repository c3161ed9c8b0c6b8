"""Deep-feature extractors of the dynacell feature tier (counterpart of
``viscy_tpu/apps/dynacell/eval/features.py``).

- :class:`RandomProjectionExtractor`: a seeded Gaussian projection of each
  ``(P, P)`` crop (numpy on the host, as JAX's). Its default seed is
  ``zlib.crc32(kind) % 997``, the same in every process; JAX's is
  ``hash(kind) % 997``, which Python salts per process (``ROADMAP.md``
  Queue 3).
- :class:`TorchEncoderExtractor`: a torch module's forward on the device.
  The crops are stacked into ``(N, 1, P, P)``, each cropped at its top-left
  ``P x P`` and zero-padded (JAX's code; its docstring says "resized"), and
  run in chunks of ``batch_cap`` under the runtime's device lock.
- :func:`load_eval_models`: ``type: contrastive`` builds a
  ``ContrastiveEncoder`` (its embedding of ``(N, 1, 1, P, P)``), ``type:
  dino`` a ``DinoViT`` (the grayscale crop repeated to RGB, its ``cls``
  token). ``checkpoint`` is a ``.pt`` state dict under the port's names or
  a ``viscy-torch fit`` checkpoint (of a ``ContrastiveModule``); an Orbax
  directory of the JAX package raises by name. A backbone that fails to
  load raises (JAX logs it and skips it).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from viscy_tpu_torch.apps.dynacell.eval._ops import host, resolve_device

__all__ = ["RandomProjectionExtractor", "TorchEncoderExtractor", "EvalModels", "load_eval_models",
           "default_projection_seed"]


def default_projection_seed(kind: str) -> int:
    """The random projection's seed when the config names none."""
    return zlib.crc32(kind.encode()) % 997


class RandomProjectionExtractor:
    """Seeded random-projection embedding of ``(P, P)`` crops to ``dim``
    features: deterministic and model-free."""

    def __init__(self, patch_size: int, dim: int = 64, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        self._w = rng.standard_normal((patch_size * patch_size, dim)).astype(np.float32) / np.sqrt(
            patch_size * patch_size)
        self.patch_size = patch_size
        self.dim = dim

    def extract_features_batch(self, crops: list[np.ndarray]) -> np.ndarray:
        x = np.stack([np.asarray(c, np.float32).ravel() for c in crops])
        return x @ self._w


class TorchEncoderExtractor:
    """Batch extractor over ``forward(batch) -> (N, d)`` of a module on
    ``device``; ``batch`` is the ``(N, 1, P, P)`` float32 crop stack."""

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor], patch_size: int, batch_cap: int = 256,
                 device="cuda") -> None:
        self.forward = forward
        self.patch_size = patch_size
        self.batch_cap = batch_cap
        self.device = resolve_device(device)

    def stack(self, crops: list[np.ndarray]) -> np.ndarray:
        p = self.patch_size
        batch = np.zeros((len(crops), 1, p, p), np.float32)
        for i, c in enumerate(crops):
            c = np.asarray(c, np.float32)
            h, w = c.shape[:2]
            batch[i, 0, : min(h, p), : min(w, p)] = c[:p, :p]
        return batch

    def extract_features_batch(self, crops: list[np.ndarray]) -> np.ndarray:
        from viscy_tpu_torch.apps.dynacell.eval.runtime import device_serialization_lock

        batch = self.stack(crops)
        outs = []
        with device_serialization_lock, torch.inference_mode():
            for i in range(0, len(batch), self.batch_cap):
                chunk = torch.from_numpy(batch[i: i + self.batch_cap]).to(self.device)
                outs.append(host(self.forward(chunk).float()))
        return np.concatenate(outs, axis=0)


@dataclass
class EvalModels:
    """The loaded feature extractors and segmentation model of a run."""

    extractors: dict[str, Any] = field(default_factory=dict)
    seg_model: Any = None


def load_eval_models(config: dict, device="cuda") -> EvalModels:
    """Extractors from ``config["feature_metrics"]``: for each of
    ``dinov3``, ``dynaclr`` and ``celldino`` a spec ``{"type":
    "random_projection", "dim", "seed"}``, ``{"type": "contrastive",
    "checkpoint", "model_config"}`` or ``{"type": "dino", "checkpoint",
    "model_config"}``."""
    from viscy_tpu_torch.apps.dynacell.eval.segmentation import prepare_segmentation_model

    fm = dict(config.get("feature_metrics") or {})
    patch_size = int(fm.get("patch_size", 64))
    extractors: dict[str, Any] = {}
    for kind in ("dinov3", "dynaclr", "celldino"):
        spec = fm.get(kind)
        if not spec:
            continue
        if isinstance(spec, dict) and spec.get("type", "random_projection") == "random_projection":
            seed = int(spec.get("seed", default_projection_seed(kind)))
            extractors[kind] = RandomProjectionExtractor(patch_size, dim=int(spec.get("dim", 64)), seed=seed)
            continue
        extractors[kind] = _load_model_extractor(kind, spec, patch_size, device)
    return EvalModels(extractors=extractors, seg_model=prepare_segmentation_model(config))


def _state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A backbone's weights: a ``.pt`` state dict or a ``viscy-torch fit``
    checkpoint (its auxiliary heads dropped)."""
    from viscy_tpu_torch.training.trainer import read_checkpoint

    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory, an Orbax checkpoint of the JAX package, which viscy_tpu_torch cannot read: "
            "convert its params with viscy_tpu_torch.training.convert (contrastive_state_dict_from_flax or "
            "dinovit_state_dict_from_flax), torch.save the state dict and name that file as checkpoint")
    _, state = read_checkpoint(path)
    return {k: v for k, v in state.items() if not k.startswith("aux_heads.")}


def _load_model_extractor(kind: str, spec: dict, patch_size: int, device) -> TorchEncoderExtractor:
    dev = resolve_device(device)
    mtype = spec.get("type")
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in (spec.get("model_config") or {}).items()}
    if mtype == "contrastive":
        from viscy_tpu_torch.models.contrastive.encoder import ContrastiveEncoder

        model = ContrastiveEncoder(**cfg)

        def forward(batch: torch.Tensor) -> torch.Tensor:
            return model(batch[:, :, None])[0]  # (N, 1, P, P) -> (N, 1, 1, P, P)
    elif mtype == "dino":
        from viscy_tpu_torch.models.foundation.vit import DinoViT

        model = DinoViT(**cfg)

        def forward(batch: torch.Tensor) -> torch.Tensor:
            return model(batch.repeat(1, 3, 1, 1))["cls"]  # grayscale -> RGB
    else:
        raise ValueError(f"unknown feature backbone type {mtype!r} for {kind}")
    if "checkpoint" not in spec:
        raise ValueError(f"feature backbone {kind!r} of type {mtype!r} needs a checkpoint")
    state = _state_dict(spec["checkpoint"])
    # BatchNorm step counters have no flax counterpart: a bridged state dict lacks them
    state.update({k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked") and k not in state})
    model.load_state_dict(state, strict=True)
    model.to(dev).eval()
    return TorchEncoderExtractor(forward, patch_size, device=dev)
