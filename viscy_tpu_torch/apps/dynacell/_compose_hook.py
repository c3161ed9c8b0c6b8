"""Composition-time resolver of DynaCell benchmark leaves (counterpart of
``viscy_tpu/apps/dynacell/_compose_hook.py``; reference
``dynacell/_compose_hook.py``).

Hand :func:`dynacell_ref_resolver` to
:func:`viscy_tpu_torch.training.compose.load_composed_config` as
``resolver=``; it runs once, after the last deep merge. A full
``benchmark.dataset_ref: {dataset, target}`` is resolved against the
manifests (:mod:`.manifests`) and its ``data_path``, ``source_channel``
and ``target_channel`` spliced into ``data.init_args``, its spacing into
``benchmark.spacing``; a partial reference does nothing.
"""

from __future__ import annotations

import copy
import sys

from viscy_tpu_torch.apps.dynacell.manifests import (
    DatasetRef,
    ResolvedDataset,
    dataset_ref_from_dict,
    resolve_dataset_ref,
)

__all__ = ["dynacell_ref_resolver"]

_MODES = {"fit", "predict", "validate"}


def _infer_mode(composed: dict) -> str:
    """The subcommand (fit, predict, validate): the leaf config's
    ``launcher.mode``, else the first of them on the command line."""
    launcher_mode = composed.get("launcher", {}).get("mode")
    if launcher_mode in _MODES:
        return launcher_mode
    for arg in sys.argv[1:]:
        if arg in _MODES:
            return arg
    raise ValueError("Cannot infer mode for dataset_ref resolution; set launcher.mode in the leaf config.")


def _splice_resolved(composed: dict, resolved: ResolvedDataset, mode: str, ref: DatasetRef) -> dict:
    """The resolved fields in ``data.init_args``: a full reference is the
    one source of them, so a field the config also sets is an error."""
    out = copy.deepcopy(composed)
    init_args = out.setdefault("data", {}).setdefault("init_args", {})
    resolved_values = {
        "data_path": str(resolved.data_path_test if mode == "predict" else resolved.data_path_train),
        "source_channel": resolved.source_channel,
        "target_channel": resolved.target_channel,
    }
    conflicts = {f: (init_args[f], v) for f, v in resolved_values.items() if f in init_args}
    if conflicts:
        details = "; ".join(f"{k}: composed={c!r} vs manifest={m!r}" for k, (c, m) in conflicts.items())
        raise ValueError(f"benchmark.dataset_ref={{dataset: {ref.dataset}, target: {ref.target}}} "
                         f"conflicts with explicit data.init_args fields: {details}.")
    init_args.update(resolved_values)
    out.setdefault("benchmark", {})["spacing"] = resolved.spacing.as_list()
    return out


def dynacell_ref_resolver(composed: dict) -> dict:
    """Resolve ``benchmark.dataset_ref``: nothing unless both keys are set."""
    ref = dataset_ref_from_dict(composed.get("benchmark", {}).get("dataset_ref"))
    if ref is None:
        return composed
    return _splice_resolved(composed, resolve_dataset_ref(ref), _infer_mode(composed), ref)
