"""The released-checkpoint parity harness (counterpart of
``viscy_tpu/training/parity.py``).

Its contract is the reference reproducibility test's
(``applications/cytoland/tests/test_inference_reproducibility.py:50-73``):
a released checkpoint, run through the production prediction pipeline,
matches the released reference predictions within atol 0.02 and rtol 1e-2,
with a per-channel Pearson r above 0.999.

Released checkpoints and their fixture stores are not in the repository,
so the harness is gated on them: give local copies as the command's
options or through ``VISCY_PARITY_CHECKPOINT``, ``VISCY_PARITY_DATA`` and
``VISCY_PARITY_REFERENCE``. Without them it runs the offline tiers and
records them in the report.

Tiers
-----
1. **Weight audit** (:func:`layerwise_weight_audit`). The port's modules
   carry the reference torch names, so a released state dict loads into
   them by name: the audit checks coverage both ways between a state dict
   and a module's ``state_dict()``, each shape, and each tensor's Frobenius
   norm against the module's (or, for a state dict that came out of a
   flax-to-torch bridge of :mod:`viscy_tpu_torch.training.convert`, the
   multiset of norms against the flax tree's). :func:`converter_dryruns`
   builds each released architecture's zero state dict from
   :mod:`~viscy_tpu_torch.training.state_dict_inventory` and loads it
   strictly into the port's model at the same arguments.
2. **Activation capture** (:func:`capture_activations`,
   :func:`compare_activations`): per-module statistics of a forward (forward
   hooks on every named module), and the arrays on request.
   :func:`export_activations` writes the ``.npz`` (torch module name ->
   NC[D]HW array) that both packages' ``compare_activations`` read.
3. **Prediction parity** (:func:`run_checkpoint_parity`): the whole
   contract against a reference-prediction store.

Usage
-----
``python -m viscy_tpu_torch.training.parity --output PARITY.json
[--checkpoint ckpt.ckpt --data fixture.zarr --reference reference.zarr]
[--device cpu]`` (the card by default).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np
import torch

ATOL = 0.02
RTOL = 1e-2
MIN_PEARSON_R = 0.999

# the JAX harness's model, which its comment matches to the fine-tuned
# VSCyto3D checkpoint (reference test_inference_reproducibility.py:55-67);
# the inventory's "vscyto3d" is a UNeXt2 at depth 5 (ROADMAP.md Queue 3)
VSCYTO3D_MODEL_CONFIG = {
    "in_channels": 1,
    "out_channels": 2,
    "encoder_blocks": [3, 3, 9, 3],
    "dims": [96, 192, 384, 768],
    "decoder_conv_blocks": 2,
    "stem_kernel_size": (5, 4, 4),
    "in_stack_depth": 15,
    "pretraining": False,
}
SOURCE_CHANNEL = "Phase3D"
TARGET_CHANNELS = ["Membrane", "Nuclei"]

__all__ = [
    "layerwise_weight_audit",
    "capture_activations",
    "export_activations",
    "compare_activations",
    "compare_predictions",
    "converter_dryruns",
    "run_checkpoint_parity",
    "write_parity_report",
]


# -- tier 1: weight audit -------------------------------------------------------------


@dataclass
class WeightAudit:
    """A state dict against a module (``n_model_keys`` and the coverage
    lists) and, when given, against the tree it was bridged from
    (``n_source_leaves`` and the norm multiset)."""

    n_torch_keys: int = 0
    n_source_leaves: int = 0
    n_model_keys: int = 0
    unmatched_torch_keys: list[str] = field(default_factory=list)
    missing_model_keys: list[str] = field(default_factory=list)
    shape_mismatches: list[str] = field(default_factory=list)
    norm_mismatches: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.unmatched_torch_keys or self.missing_model_keys or self.shape_mismatches
                    or self.norm_mismatches)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _norm(v) -> float:
    return float(np.linalg.norm(_host(v).astype(np.float64).ravel()))


def layerwise_weight_audit(
    torch_state: dict,
    model: torch.nn.Module | dict | None = None,
    source: dict | None = None,
    norm_rtol: float = 1e-5,
) -> WeightAudit:
    """Audit ``torch_state`` (key -> tensor or array).

    Against ``model`` (a module, or its ``state_dict()``): state-dict keys
    the model lacks, model keys the state dict lacks, shapes, and each
    shared key's Frobenius norm (after a load they are equal, so a mismatch
    is a weight the load did not carry or carried wrong). Against
    ``source`` (the nested flax tree a bridge mapped): the multiset of
    norms, which the bridges' transposes and reshapes keep, so a mismatch
    is a wrong mapping (two layers swapped) that a structural round trip
    cannot show.
    """
    audit = WeightAudit(n_torch_keys=len(torch_state))
    if source is not None:
        flat = _flatten(source)
        audit.n_source_leaves = len(flat)
        theirs = sorted(_norm(v) for v in flat.values())
        ours = sorted(_norm(v) for v in torch_state.values())
        if len(theirs) == len(ours):
            audit.norm_mismatches = [f"norm[{i}]: source {a:.6g} vs torch {b:.6g}"
                                     for i, (a, b) in enumerate(zip(theirs, ours))
                                     if not np.isclose(a, b, rtol=norm_rtol, atol=1e-7)][:20]
        else:
            audit.unmatched_torch_keys = [f"count mismatch: {len(theirs)} source vs {len(ours)} torch"]
    if model is not None:
        state = model.state_dict() if isinstance(model, torch.nn.Module) else model
        audit.n_model_keys = len(state)
        audit.unmatched_torch_keys += sorted(set(torch_state) - set(state))[:50]
        audit.missing_model_keys = sorted(set(state) - set(torch_state))[:50]
        shared = [k for k in state if k in torch_state]
        audit.shape_mismatches = [f"{k}: model {tuple(state[k].shape)} vs state dict {tuple(torch_state[k].shape)}"
                                  for k in shared if tuple(state[k].shape) != tuple(torch_state[k].shape)][:50]
        audit.norm_mismatches += [
            f"{k}: model {_norm(state[k]):.6g} vs state dict {_norm(torch_state[k]):.6g}"
            for k in shared
            if tuple(state[k].shape) == tuple(torch_state[k].shape)
            and not np.isclose(_norm(state[k]), _norm(torch_state[k]), rtol=norm_rtol, atol=1e-7)
        ][:20]
    return audit


def _released_model(name: str, kwargs: dict) -> torch.nn.Module:
    """The port's model of a released architecture at the inventory's
    arguments (float32; on the default device, e.g. ``meta`` under
    ``torch.device("meta")``)."""
    from viscy_tpu_torch.models.contrastive.encoder import ContrastiveEncoder
    from viscy_tpu_torch.models.unet.fcmae import FullyConvolutionalMAE
    from viscy_tpu_torch.models.unet.unext2 import UNeXt2

    if name == "vscyto3d":
        return UNeXt2(**kwargs)
    if name in ("vscyto2d", "fcmae_3d"):
        return FullyConvolutionalMAE(**kwargs, pretraining=False)
    if name == "dynaclr_contrastive":
        return ContrastiveEncoder(**kwargs)
    raise KeyError(name)


def converter_dryruns() -> dict:
    """For each of the released architectures, the state dict a released
    checkpoint holds (names and shapes from the source-derived inventory,
    zeros) loaded strictly into the port's model at the same arguments:
    ``status`` (``ok``, ``uncovered_keys``, or ``error`` with its
    ``detail``), the inventory's ``torch_keys``, the model keys the load
    filled (``converted_leaves``) and the first ``uncovered`` keys (the
    inventory's the model lacks, then the model's the inventory lacks). The
    models are built on the ``meta`` device (names and shapes only) and
    take the zeros by assignment."""
    from viscy_tpu_torch.training.state_dict_inventory import RELEASED_ARCHITECTURES, released_inventory

    out: dict = {}
    for name, (_, kwargs) in RELEASED_ARCHITECTURES.items():
        try:
            inventory = released_inventory(name)
            with torch.device("meta"):
                model = _released_model(name, dict(kwargs))
            sd = {k: torch.zeros(shape) for k, shape in inventory.items()}
            result = model.load_state_dict(sd, strict=False, assign=True)
            uncovered = [*result.unexpected_keys, *result.missing_keys]
            out[name] = {
                "status": "ok" if not uncovered else "uncovered_keys",
                "torch_keys": len(inventory),
                "converted_leaves": len(set(inventory) & set(model.state_dict())),
                "uncovered": uncovered[:8],
            }
        except Exception as e:  # noqa: BLE001 - a report line, as in JAX
            out[name] = {"status": "error", "detail": f"{type(e).__name__}: {e}"}
    return out


# -- tier 2: activation capture ---------------------------------------------------------


def _stats(a: np.ndarray, with_arrays: bool) -> dict:
    stats = {"shape": list(a.shape), "mean": float(a.mean()), "std": float(a.std()), "min": float(a.min()),
             "max": float(a.max())}
    if with_arrays:
        stats["array"] = a
    return stats


def capture_activations(model: torch.nn.Module, x, with_arrays: bool = False) -> dict:
    """One eval-mode forward of ``model`` on ``x`` (moved to the model's
    device) with a forward hook on every named module: module path ->
    ``shape`` / ``mean`` / ``std`` / ``min`` / ``max`` of its output (as
    float32 on the host; a tuple output gives ``path[i]`` per tensor), plus
    the array under ``"array"`` when ``with_arrays``. The model's own
    output is ``"output"``."""
    device = next(model.parameters()).device
    out: dict[str, dict] = {}

    def record(path: str, value) -> None:
        if isinstance(value, torch.Tensor):
            out[path] = _stats(value.detach().float().cpu().numpy(), with_arrays)
        elif isinstance(value, (tuple, list)):
            for i, v in enumerate(value):
                if isinstance(v, torch.Tensor):
                    out[f"{path}[{i}]"] = _stats(v.detach().float().cpu().numpy(), with_arrays)

    hooks = [m.register_forward_hook(lambda _m, _i, o, path=name: record(path, o))
             for name, m in model.named_modules() if name]
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            record("output", model(torch.as_tensor(np.asarray(x), device=device)))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return out


def export_activations(acts: dict, path: str | Path) -> Path:
    """The captured arrays (``capture_activations(..., with_arrays=True)``)
    as an ``.npz`` of module path -> NC[D]HW array: the torch-side export
    that ``compare_activations`` reads, in this package and in JAX's."""
    path = Path(path)
    np.savez(path, **{k: v["array"] for k, v in acts.items() if "array" in v})
    return path


def compare_activations(acts: dict, torch_npz: str | Path, name_map=None, atol: float = 1e-3,
                        rtol: float = 1e-3) -> dict:
    """Captured activations against a torch-side ``.npz`` (module name ->
    NC[D]HW array). An array whose shape differs is tried channels-last
    (NHWC / NDHWC) too, so a capture in either layout compares;
    ``name_map`` maps an ``.npz`` name to a capture path (default: the
    same). Per name: ``status`` (``ok``, ``diverged``, ``missing``,
    ``shape_mismatch``) and the largest and mean absolute difference."""
    theirs = np.load(torch_npz)
    results = {}
    for tname in theirs.files:
        name = name_map(tname) if name_map else tname
        if name not in acts or "array" not in acts[name]:
            results[tname] = {"status": "missing"}
            continue
        ours = acts[name]["array"]
        ref = theirs[tname]
        if ref.shape != ours.shape and ref.ndim in (4, 5):
            ref_t = np.transpose(ref, (0, 2, 3, 1) if ref.ndim == 4 else (0, 2, 3, 4, 1))
            if ref_t.shape == ours.shape:
                ref = ref_t
        if ref.shape != ours.shape:
            results[tname] = {"status": "shape_mismatch", "torch": list(ref.shape), "capture": list(ours.shape)}
            continue
        diff = np.abs(ours - ref)
        results[tname] = {
            "status": "ok" if np.allclose(ours, ref, atol=atol, rtol=rtol) else "diverged",
            "max_abs_diff": float(diff.max()),
            "mean_abs_diff": float(diff.mean()),
        }
    return results


# -- tier 3: prediction parity ----------------------------------------------------------


def compare_predictions(pred: np.ndarray, reference: np.ndarray, channel_names: list[str], atol: float = ATOL,
                        rtol: float = RTOL, min_pearson: float = MIN_PEARSON_R) -> dict:
    """Per channel: the share of voxels within atol / rtol, the largest
    absolute difference and the Pearson r; a channel passes with every
    voxel within tolerance and r above ``min_pearson``. ``pred`` and
    ``reference`` are (C, Z, Y, X) or (T, C, Z, Y, X)."""
    pred = np.asarray(pred, np.float64)
    reference = np.asarray(reference, np.float64)
    if pred.shape != reference.shape:
        raise ValueError(f"shape mismatch: {pred.shape} vs {reference.shape}")
    c_axis = 0 if pred.ndim == 4 else 1
    out: dict = {"channels": {}, "pass": True}
    for i, name in enumerate(channel_names):
        p = np.take(pred, i, axis=c_axis).ravel()
        r = np.take(reference, i, axis=c_axis).ravel()
        close = np.isclose(p, r, atol=atol, rtol=rtol)
        denom = p.std() * r.std()
        pearson = float(np.corrcoef(p, r)[0, 1]) if denom > 0 else float("nan")
        ch = {
            "pearson_r": pearson,
            "frac_within_tol": float(close.mean()),
            "max_abs_diff": float(np.abs(p - r).max()),
            "pass": bool(pearson > min_pearson and close.all()),
        }
        out["channels"][name] = ch
        out["pass"] = out["pass"] and ch["pass"]
    return out


def _first_position(store, fov: str | None):
    if not hasattr(store, "positions"):
        return store
    if fov is not None and fov in store:
        return store[fov]
    return next(store.positions())[1]


def run_checkpoint_parity(
    checkpoint_path: str | Path,
    data_zarr: str | Path,
    reference_zarr: str | Path,
    model_config: dict | None = None,
    source_channel: str = SOURCE_CHANNEL,
    target_channels: list[str] | None = None,
    fov: str | None = None,
    time_index: int = 0,
    device: str = "cuda",
) -> dict:
    """The whole contract: load the checkpoint (``torch.load(weights_only=
    True)``, its ``state_dict``, Lightning's ``model.`` prefix taken off)
    into the port's ``FcmaeUNet`` (strictly, by name), normalize the fixture FOV's source
    channel with its stored ``fov_statistics``, predict it through
    ``AugmentedPredictionVSUNet.predict_sliding_windows`` on ``device``, and
    compare with the reference store's target channels. The result holds
    :func:`compare_predictions`' keys, the state dict's ``weight_audit``
    against the loaded model, and the ``checkpoint`` path."""
    from viscy_tpu_torch.apps.cytoland.engine import FcmaeUNet
    from viscy_tpu_torch.apps.cytoland.prediction import AugmentedPredictionVSUNet
    from viscy_tpu_torch.data.utils import read_norm_meta
    from viscy_tpu_torch.training.trainer import read_checkpoint
    from viscy_tpu_torch.zarr_io.store import open_ome_zarr

    model_config = dict(model_config or VSCYTO3D_MODEL_CONFIG)
    target_channels = target_channels or TARGET_CHANNELS

    _, torch_state = read_checkpoint(checkpoint_path)
    module = FcmaeUNet(model_config=model_config, device=device)
    module.model.load_state_dict(torch_state, strict=True)
    module.model.eval()

    pos = _first_position(open_ome_zarr(str(data_zarr), mode="r"), fov)
    norm = read_norm_meta(pos)
    source = np.asarray(pos.data[time_index, pos.channel_names.index(source_channel)], np.float32)
    if norm and source_channel in norm:
        stats = norm[source_channel].get("fov_statistics", {})
        mean = stats.get("mean", 0.0)
        std = stats.get("std", 1.0) or 1.0
        source = (source - mean) / std
    predictor = AugmentedPredictionVSUNet(model=module.model)
    pred = predictor.predict_sliding_windows(torch.from_numpy(np.ascontiguousarray(source[None, None])),
                                             out_channel=len(target_channels))[0]

    ref_pos = _first_position(open_ome_zarr(str(reference_zarr), mode="r"), fov)
    reference = np.asarray(ref_pos.data[time_index])[[ref_pos.channel_names.index(c) for c in target_channels]]

    result = compare_predictions(pred, reference, target_channels)
    audit = layerwise_weight_audit(torch_state, module.model)
    result["weight_audit"] = asdict(audit) | {"ok": audit.ok}
    result["checkpoint"] = str(checkpoint_path)
    return result


# -- report and entry point -------------------------------------------------------------


def write_parity_report(output: str | Path, device: str = "cuda", **overrides) -> dict:
    """Run the tiers the available artifacts allow and write the JSON
    report. The artifacts' paths come from ``overrides`` (``checkpoint``,
    ``data``, ``reference``) or the ``VISCY_PARITY_*`` variables; with all
    three present the contract runs on ``device``."""
    ckpt = overrides.get("checkpoint") or os.environ.get("VISCY_PARITY_CHECKPOINT")
    data = overrides.get("data") or os.environ.get("VISCY_PARITY_DATA")
    ref = overrides.get("reference") or os.environ.get("VISCY_PARITY_REFERENCE")
    report: dict = {
        "contract": {
            "atol": ATOL,
            "rtol": RTOL,
            "min_pearson_r": MIN_PEARSON_R,
            "source": "reference test_inference_reproducibility.py:50-73",
        },
        "converter_dryruns": converter_dryruns(),
        "run_when_artifacts_appear": [
            "python -m viscy_tpu_torch.training.parity --output PARITY.json "
            "--checkpoint /path/to/released.ckpt "
            "--data /path/to/fixture_plate.zarr "
            "--reference /path/to/reference_predictions.zarr",
            "# or set VISCY_PARITY_CHECKPOINT / VISCY_PARITY_DATA / VISCY_PARITY_REFERENCE; "
            "the contract runs once all three paths exist",
        ],
    }
    if ckpt and data and ref and all(Path(p).exists() for p in (ckpt, data, ref)):
        report["status"] = "executed"
        report["result"] = run_checkpoint_parity(ckpt, data, ref, device=device)
    else:
        report["status"] = "artifacts_unavailable"
        report["detail"] = (
            "released torch checkpoint / fixture zarr / reference predictions not present; the offline "
            "tiers (weight audit, converter dry runs, activation capture) ran or run in "
            "tests/test_torch_port_parity_tools.py"
        )
        report["missing_artifacts"] = [name for name, p in (("checkpoint", ckpt), ("data", data),
                                                             ("reference", ref)) if not p or not Path(p).exists()]
    Path(output).write_text(json.dumps(report, indent=2))
    return report


def main(argv: list[str] | None = None) -> dict:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m viscy_tpu_torch.training.parity",
                                     description="Released-checkpoint parity harness.")
    parser.add_argument("--output", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--data", default=None)
    parser.add_argument("--reference", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    from viscy_tpu_torch.device import resolve_device

    resolve_device(args.device)
    report = write_parity_report(args.output, device=args.device, checkpoint=args.checkpoint, data=args.data,
                                 reference=args.reference)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
