"""Supervised MLP embedder over cell embeddings (counterpart of
``viscy_tpu/apps/dynaclr/mlp_embedder.py``): train an MLP classifier on a
label column, then use its L2-normalized last hidden layer as a
task-adapted embedding.

The model is the port's :class:`~viscy_tpu_torch.models.components.heads.
MLP` (``norm="ln"``, ReLU, a linear head), trained in float32 on the device
with ``torch.optim.AdamW`` (the update of ``optax.adamw``: decoupled decay
on the parameter before the step, eps 1e-8) and the mean cross-entropy.
Classes are the sorted unique labels (sklearn's ``LabelEncoder``). The
split and every epoch's batch order are numpy's ``default_rng(seed)``
draws, as JAX draws them; a batch of fewer than two rows is skipped, as in
JAX. The initial weights come from a torch generator seeded with ``seed``,
or from ``init_state`` (e.g. JAX's initial params through
:func:`viscy_tpu_torch.training.convert.mlp_state_dict_from_flax`).

A checkpoint is ``<output>.pt`` (the state_dict) beside ``<output>.json``
(``in_dims``, ``hidden_dims``, ``classes``). The JAX package writes flax
``.msgpack`` weights, which the card's machine cannot read (no flax): such
a checkpoint raises by name; carry one across with ``mlp_state_dict_from_flax``
where flax is installed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.models.components.heads import MLP

__all__ = ["apply_mlp_embedder", "load_mlp_embedder", "train_mlp_embedder"]


def _build(in_dims: int, hidden_dims, num_classes: int, seed: int = 0) -> MLP:
    return MLP(in_dims, list(hidden_dims), torch.Generator().manual_seed(seed), num_classes=num_classes,
               cosine_classifier=False)


def train_mlp_embedder(features, labels, hidden_dims=(256, 128), epochs: int = 30, batch_size: int = 256,
                       lr: float = 1e-3, weight_decay: float = 1e-4, val_fraction: float = 0.2, seed: int = 42,
                       output_path: str | Path | None = None, init_state: dict | None = None,
                       device: str = "cuda") -> tuple[dict, dict]:
    """Train the classifier; returns ``(checkpoint, metrics)``: the
    checkpoint's ``state_dict``, ``in_dims``, ``hidden_dims`` and
    ``classes``; the metrics' last ``val_acc`` and the per-epoch
    ``history`` of validation loss and accuracy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    features = np.asarray(features, np.float32)
    classes, y = np.unique(np.asarray(labels), return_inverse=True)
    perm = rng.permutation(len(features))
    n_val = max(1, int(len(features) * val_fraction))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    model = _build(features.shape[1], hidden_dims, len(classes), seed)
    if init_state is not None:
        model.load_state_dict(init_state)
    model = model.to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    x_all = torch.as_tensor(features, device=dev)
    y_all = torch.as_tensor(y, device=dev)
    x_val, y_val = x_all[torch.as_tensor(val_idx, device=dev)], y_all[torch.as_tensor(val_idx, device=dev)]
    history = []
    for epoch in range(epochs):
        # the epoch's order goes to the device once: a host index a batch would wait for the card each step
        order = torch.as_tensor(rng.permutation(train_idx), device=dev)
        model.train()
        for i in range(0, len(order), batch_size):
            sel = order[i: i + batch_size]
            if len(sel) < 2:
                continue
            loss = F.cross_entropy(model(x_all[sel]), y_all[sel])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        model.eval()
        with torch.no_grad():
            logits = model(x_val)
            vloss = F.cross_entropy(logits, y_val)
            vacc = (logits.argmax(dim=-1) == y_val).float().mean()
        history.append({"epoch": epoch, "val_loss": float(vloss), "val_acc": float(vacc)})
    ckpt = {
        "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "in_dims": int(features.shape[1]),
        "hidden_dims": list(hidden_dims),
        "classes": [str(c) for c in classes],
    }
    metrics = {"val_acc": history[-1]["val_acc"], "history": history}
    if output_path is not None:
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(ckpt["state_dict"], output_path.with_suffix(".pt"))
        meta = {k: v for k, v in ckpt.items() if k != "state_dict"}
        output_path.with_suffix(".json").write_text(json.dumps(meta))
    return ckpt, metrics


def load_mlp_embedder(path: str | Path, device: str = "cuda") -> tuple[MLP, dict]:
    """The model (on ``device``, in eval mode) and the JSON sidecar."""
    path = Path(path)
    if not path.with_suffix(".pt").exists() and path.with_suffix(".msgpack").exists():
        raise NotImplementedError(
            f"{path.with_suffix('.msgpack')}: a JAX (flax msgpack) MLP embedder cannot be read by viscy_tpu_torch; "
            "convert its params with viscy_tpu_torch.training.convert.mlp_state_dict_from_flax where flax is "
            "installed and save the state_dict as <path>.pt")
    meta = json.loads(path.with_suffix(".json").read_text())
    model = _build(meta["in_dims"], meta["hidden_dims"], len(meta["classes"]))
    model.load_state_dict(torch.load(path.with_suffix(".pt"), map_location="cpu", weights_only=True))
    return model.to(resolve_device(device)).eval(), meta


def apply_mlp_embedder(features, model_path: str | Path, device: str = "cuda") -> np.ndarray:
    """L2-normalized last-hidden-layer representations of all rows
    (float32)."""
    model, _ = load_mlp_embedder(model_path, device=device)
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(torch.as_tensor(np.asarray(features, np.float32), device=dev), encode=True)
    return out.cpu().numpy()
