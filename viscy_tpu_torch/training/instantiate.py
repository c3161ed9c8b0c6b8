"""``class_path`` / ``init_args`` instantiation (counterpart of
``viscy_tpu/training/instantiate.py``).

A dict ``{"class_path": "pkg.mod.Cls", "init_args": {...}}`` is imported
and constructed, recursively. Class paths of the reference packages
(``viscy_*``, ``cytoland``, ``dynaclr``, ``dynacell``, Lightning's callbacks) and of the JAX package
(``viscy_tpu.*``) are remapped to this package before anything is
imported, so the JAX configs run unchanged and ``viscy_tpu`` is never
imported. A class the port lacks raises an ``ImportError`` naming it.
"""

from __future__ import annotations

import importlib
from typing import Any

# module prefix -> port module prefix (the longest prefix wins)
_MODULE_ALIASES: dict[str, str] = {
    "viscy_tpu": "viscy_tpu_torch",
    "viscy_transforms": "viscy_tpu_torch.transforms",
    "viscy_data": "viscy_tpu_torch.data",
    "viscy_models": "viscy_tpu_torch.models",
    "viscy_utils.losses": "viscy_tpu_torch.training.losses",
    "viscy_utils.callbacks": "viscy_tpu_torch.training.callbacks",
    "viscy_utils.trainer": "viscy_tpu_torch.training.trainer",
    "viscy_utils": "viscy_tpu_torch.training",
    "cytoland.engine": "viscy_tpu_torch.apps.cytoland.engine",
    "cytoland": "viscy_tpu_torch.apps.cytoland",
    "dynaclr.engine": "viscy_tpu_torch.apps.dynaclr.engine",
    "dynaclr": "viscy_tpu_torch.apps.dynaclr",
    "dynacell.engine": "viscy_tpu_torch.apps.dynacell.engine",
    "dynacell": "viscy_tpu_torch.apps.dynacell",
    "lightning.pytorch.callbacks": "viscy_tpu_torch.training.callbacks",
    "viscy.transforms": "viscy_tpu_torch.transforms",
    "viscy.data": "viscy_tpu_torch.data",
    "viscy.unet.networks": "viscy_tpu_torch.models.unet",
}

# class-name fallbacks where the port keeps a class in another module
_CLASS_FALLBACKS: dict[str, str] = {
    "ModelCheckpoint": "viscy_tpu_torch.training.callbacks.checkpoint.ModelCheckpoint",
    "LearningRateMonitor": "viscy_tpu_torch.training.callbacks.checkpoint.LearningRateMonitor",
    "HCSPredictionWriter": "viscy_tpu_torch.training.callbacks.prediction_writer.HCSPredictionWriter",
    "EmbeddingWriter": "viscy_tpu_torch.training.callbacks.embedding_writer.EmbeddingWriter",
    "EmbeddingSnapshotCallback": "viscy_tpu_torch.training.callbacks.embedding_snapshot.EmbeddingSnapshotCallback",
    "OnlineEvalCallback": "viscy_tpu_torch.training.callbacks.online_eval.OnlineEvalCallback",
}

# the JAX package, JAX itself and the reference packages' import aliases
# (which load the JAX package): never imported from here
_FOREIGN = (
    "viscy_tpu", "jax", "flax", "viscy", "viscy_data", "viscy_models", "viscy_transforms", "viscy_utils",
    "cytoland", "dynaclr", "dynacell", "qc", "airtable_utils",
)


def remap_class_path(class_path: str) -> str:
    for prefix, target in sorted(_MODULE_ALIASES.items(), key=lambda kv: -len(kv[0])):
        if class_path == prefix or class_path.startswith(prefix + "."):
            return target + class_path[len(prefix) :]
    return class_path


def _import(path: str):
    module_name, _, cls_name = path.rpartition(".")
    if module_name.split(".")[0] in _FOREIGN:
        raise ImportError(f"{path} is not a class of this package")
    return getattr(importlib.import_module(module_name), cls_name)


def resolve_class(class_path: str) -> type:
    """The port class of ``class_path``."""
    target = remap_class_path(class_path)
    try:
        return _import(target)
    except (ImportError, AttributeError):
        fallback = _CLASS_FALLBACKS.get(target.rpartition(".")[2])
        if fallback is not None:
            return _import(fallback)
        raise ImportError(
            f"class {class_path!r} (as {target!r}) is not ported to viscy_tpu_torch"
        ) from None


def instantiate(node: Any) -> Any:
    """Recursively instantiate the class_path / init_args nodes of a config tree."""
    if isinstance(node, dict):
        if "class_path" in node:
            cls = resolve_class(node["class_path"])
            init_args = instantiate(node.get("init_args", {}) or {})
            if not isinstance(init_args, dict):
                raise TypeError(f"init_args must be a dict for {node['class_path']}")
            return cls(**init_args)
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node
