"""Model export (counterpart of ``viscy_tpu/training/export.py``), from the
config's ``export:`` block: ``format``, ``export_path``, ``ckpt_path``,
``embed_params``.

- ``format: stablehlo`` (the default; JAX writes a ``jax.export`` StableHLO
  module) writes the engine's forward as a ``torch.export`` program
  (``torch.export.save``, a ``.pt2`` file): the batch is symbolic and so
  are Y and X, as multiples of the model's ``total_stride`` (the predict
  path's divisible-pad contract); if that export fails, the program keeps
  the example's YX and a symbolic batch, with a warning. With
  ``embed_params: true`` the weights are constants of the program, called
  as ``fn(x)``; otherwise it is called as ``fn(state_dict, x)`` through
  ``torch.func.functional_call``.
- ``format: orbax`` (JAX: a parameter-only Orbax checkpoint) writes the
  model's ``state_dict`` under the reference names (``torch.save``).

A program exported from CUDA tensors holds each fused MLP+GRN forward as
one ``viscy_tpu_torch::fused_mlp_grn_fwd`` node that runs the hand-written
kernels (:func:`load_exported` registers it); one exported on the CPU
traces the plain version.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch
from torch import nn

_logger = logging.getLogger("viscy_tpu_torch")


class _WithState(nn.Module):
    """``model`` called with its parameters as an input: ``(state, x)``."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, state: dict, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.model, state, (x,))


def export_model(module, export_cfg: dict) -> Path:
    """Export ``module``'s model (its weights from ``ckpt_path`` when given)
    as ``export_cfg`` says; returns the path written."""
    from torch.export import Dim

    from viscy_tpu_torch.training.trainer import read_checkpoint

    fmt = export_cfg.get("format", "stablehlo")
    if fmt not in ("stablehlo", "orbax"):
        raise ValueError(f"export format must be 'stablehlo' or 'orbax', got {fmt!r}")
    out = Path(export_cfg.get("export_path", "exported_model"))
    out.parent.mkdir(parents=True, exist_ok=True)
    model = module.model
    if export_cfg.get("ckpt_path"):
        model.load_state_dict(read_checkpoint(export_cfg["ckpt_path"])[1], strict=True)
    model.eval()
    if fmt == "orbax":
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, out)
        _logger.info(f"Saved the model's parameters (format orbax: a torch state_dict) to {out}")
        return out

    device = next(model.parameters()).device
    source = torch.from_numpy(module.example_input()["source"]).to(device)
    # batch 2: torch.export specializes a dimension whose example size is 1
    x = source.expand(2, *source.shape[1:]).contiguous()
    stride = getattr(model, "total_stride", None)
    embed = export_cfg.get("embed_params", False)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    program = model if embed else _WithState(model)
    args = (x,) if embed else (state, x)

    def do_export(spatial: bool):
        dims = {0: Dim("batch", min=1, max=65535)}
        if spatial:
            dims[3] = stride * Dim("h", min=2, max=65535 // stride)
            dims[4] = stride * Dim("w", min=2, max=65535 // stride)
        shapes = {"x": dims} if embed else {"state": {k: None for k in state}, "x": dims}
        with torch.no_grad():
            return torch.export.export(program, args, dynamic_shapes=shapes)

    try:
        exported = do_export(spatial=bool(stride))
    except Exception as e:  # torch.export raises many types; retry as the JAX export does
        if not stride:
            raise
        _logger.warning(
            f"Shape-polymorphic YX export failed ({type(e).__name__}: {e}); retrying with static spatial "
            "extents (batch stays dynamic): the program will only accept the example's spatial shape"
        )
        exported = do_export(spatial=False)
    torch.export.save(exported, out)
    _logger.info(f"Saved a torch.export program (format stablehlo, embed_params={bool(embed)}) to {out}")
    return out


def load_exported(path: str | Path):
    """The call function of a program written by :func:`export_model`:
    ``fn(x)`` for ``embed_params: true`` exports, else
    ``fn(state_dict, x)``. Importing this package registers the fused
    block's operator, so a program exported on the card runs its kernels."""
    import viscy_tpu_torch.ops.fused_block  # noqa: F401  (registers the operator)

    return torch.export.load(str(path)).module()
