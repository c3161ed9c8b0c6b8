"""One rank of ``tests/test_torch_port_parallel.py``'s two-process job, and
the engines and fits that module runs in one process beside it.

Run as ``python tests/_torch_port_parallel_worker.py <work dir>`` with
``VISCY_COORDINATOR`` (a ``file://`` store in the work directory),
``VISCY_NUM_PROCESSES`` and ``VISCY_PROCESS_ID`` set: the process joins
the gloo group through ``maybe_initialize(device="cpu")``, reads
``inputs.pt``, runs every job on its rows of each global batch and writes
``out<rank>.pt``. A watchdog ends a process that is still running after
110 s (a rank waiting in a collective another rank never joined), with
every thread's traceback on stderr. Imports no JAX.
"""

from __future__ import annotations

import faulthandler
import json
import sys
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# narrow FCMAE-UNeXt2 of the two-process fit, and its engine settings
FCMAE = dict(in_channels=1, out_channels=2, encoder_blocks=(1, 1, 1, 1), dims=(8, 16, 32, 64),
             stem_kernel_size=(5, 4, 4), in_stack_depth=5, decoder_conv_blocks=2, pretraining=False)
FCMAE_ENGINE = dict(lr=1e-3, schedule="WarmupCosine", warmup_steps=1)
# narrow stand-in for configs/dynaclr_fit.yml's encoder, as tests/test_torch_port_contrastive.py's
CONTRASTIVE = dict(backbone="convnext_test", in_channels=2, in_stack_depth=10, stem_kernel_size=(5, 4, 4),
                   stem_stride=(5, 4, 4), embedding_dim=32, projection_dim=16)
GLOBAL_BATCH = 8
CLIP = 1e-3  # far below the narrow model's gradient norm: every update is clipped


def fcmae_engine(state: dict):
    from viscy_tpu_torch.apps.cytoland.engine import VSUNet
    from viscy_tpu_torch.training.losses.mixed_loss import MixedLoss

    module = VSUNet("fcmae", dict(FCMAE, fused_mlp=True), loss_function=MixedLoss(0.5, 0.0, 0.5), device="cpu",
                    **FCMAE_ENGINE)
    module.model.load_state_dict(state)
    return module


def contrastive_engine(state: dict):
    from viscy_tpu_torch.apps.dynaclr.engine import ContrastiveModule
    from viscy_tpu_torch.models.contrastive.loss import NTXentLoss

    module = ContrastiveModule(encoder=dict(CONTRASTIVE), loss_function=NTXentLoss(0.5), device="cpu")
    module.model.load_state_dict(state)
    return module


class InMemory:
    """A datamodule whose train loader yields the given batches."""

    def __init__(self, batches: list[dict]) -> None:
        self.batches = batches

    def setup(self, stage: str) -> None:
        pass

    def train_dataloader(self):
        return self.batches


def fcmae_fit(state: dict, batches: list[dict], rows: slice, root: Path, **trainer_kw) -> dict:
    """``Trainer.fit`` of the narrow FCMAE on ``rows`` of each global batch,
    one step per batch: the logged losses and the final weights."""
    from viscy_tpu_torch.training.trainer import Trainer

    module = fcmae_engine(state)
    local = [{k: v[rows] for k, v in b.items()} for b in batches]
    trainer = Trainer(max_steps=len(batches), log_every_n_steps=1, default_root_dir=root, device="cpu",
                      checkpoint_every_n_epochs=10**6, use_tensorboard=False, **trainer_kw)
    trainer.fit(module, InMemory(local))
    losses = None
    if trainer.is_rank_zero:
        losses = [json.loads(line)["loss/train"] for line in (root / "metrics.csv").read_text().splitlines()]
    return {"losses": losses, "params": {k: v.detach().clone() for k, v in module.model.state_dict().items()}}


def contrastive_step(state: dict, batch: dict, rows: slice) -> dict:
    """One NT-Xent forward and backward of ``rows`` of the global batch, the
    gradients averaged over the processes: the anchor's embedding and
    projection of those rows, the loss, every gradient and the running
    statistics after the step."""
    from viscy_tpu_torch.parallel import all_reduce_gradients_

    module = contrastive_engine(state).train()
    local = {k: v[rows] for k, v in batch.items()}
    (a_proj, p_proj, n_proj), a_emb = module._views(local, torch.Generator(), embedding=True)
    loss = module._contrastive_loss(a_proj, p_proj, n_proj)
    loss.backward()
    all_reduce_gradients_(module.parameters())
    stats = {k: v.clone() for k, v in module.model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    return {"loss": float(loss.detach()), "embedding": a_emb.detach(), "projection": a_proj.detach(),
            "grads": {n: p.grad.clone() for n, p in module.model.named_parameters()}, "stats": stats}


def head_step(batch: dict, rows: slice) -> dict:
    """One forward and backward of a seeded ``CrossModalContrastiveHead``
    (in-batch InfoNCE; rows with a NaN target unpaired) on ``rows``, the
    gradients averaged over the processes: the loss and every gradient."""
    from viscy_tpu_torch.models.components.heads import CrossModalContrastiveHead
    from viscy_tpu_torch.parallel import all_reduce_gradients_

    head = CrossModalContrastiveHead(in_dims=32, target_dims=5, proj_dims=16, image_hidden=16, target_hidden=8,
                                     generator=torch.Generator().manual_seed(0))
    loss, _ = head(batch["x"][rows], batch["y"][rows])
    loss.backward()
    all_reduce_gradients_(head.parameters())
    return {"loss": float(loss.detach()), "grads": {n: p.grad.clone() for n, p in head.named_parameters()}}


@contextmanager
def _replaced(module, name: str, value):
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


def main(work: Path) -> None:
    faulthandler.dump_traceback_later(110, exit=True)
    torch.set_num_threads(1)
    from viscy_tpu_torch.data import loader
    from viscy_tpu_torch.models.components import blocks
    from viscy_tpu_torch.models.contrastive import loss as contrastive_loss
    from viscy_tpu_torch.parallel import maybe_initialize, process_count, process_index
    from viscy_tpu_torch.training import cli

    assert maybe_initialize(device="cpu") and maybe_initialize(device="cpu")  # idempotent
    rank, world = process_index(), process_count()
    per = GLOBAL_BATCH // world
    rows = slice(rank * per, (rank + 1) * per)
    inputs = torch.load(work / "inputs.pt", weights_only=True)
    out: dict = {"rank": rank, "world": world}

    # the CLI fit first, each window read recorded as (train loader?, index)
    reads: list[tuple[bool, int]] = []
    load_item = loader.DataLoader._load_item

    def spy(self, idx):
        reads.append((bool(self.shuffle), int(idx)))
        return load_item(self, idx)

    with _replaced(loader.DataLoader, "_load_item", spy):
        cli.main(["fit", "-c", str(work / "fit_world2.yml")])
    out["reads"] = reads

    out["fcmae"] = fcmae_fit(inputs["fcmae_state"], inputs["fcmae_batches"][:2], rows, work / "fcmae")
    out["accumulate"] = fcmae_fit(inputs["fcmae_state"], inputs["fcmae_batches"], rows, work / "accumulate",
                                  accumulate_grad_batches=2, gradient_clip_val=CLIP)
    out["contrastive"] = contrastive_step(inputs["contrastive_state"], inputs["contrastive_batch"], rows)
    out["head"] = head_step(inputs["head_batch"], rows)
    # the same step with each rank's own BatchNorm statistics, then with its own negatives
    with _replaced(blocks, "global_sum", lambda x: x):
        out["local_stats"] = contrastive_step(inputs["contrastive_state"], inputs["contrastive_batch"], rows)
    with _replaced(contrastive_loss, "gather_batch", lambda x: x):
        out["local_negatives"] = contrastive_step(inputs["contrastive_state"], inputs["contrastive_batch"], rows)
    torch.save(out, work / f"out{rank}.pt")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main(Path(sys.argv[1]))
