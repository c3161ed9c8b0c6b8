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
# narrow DynacellGAN of tests/test_torch_port_gan.py (one discriminator scale: its second is held
# there), every regularizer on, R1 / R2 every second step; its global batch and the steps each rank
# runs (d_step 0 applies R1 / R2, d_step 1 does not)
GAN_GEN = dict(in_channels=1, out_channels=2, encoder_blocks=(1, 1, 1, 1), dims=(8, 16, 32, 64), in_stack_depth=10,
               stem_kernel_size=(5, 4, 4), decoder_conv_blocks=1)
GAN_DISC = dict(base_channels=4, num_scales=1)
GAN_REGS = dict(r1_gamma=2.0, r2_gamma=1.0, r1_every=2, ema_kimg=0.01, lecam_gamma=0.5, lecam_decay=0.8)
GAN_BATCH = 2
GAN_STEPS = 2


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


def gan_engine(state: dict, engine_state: dict):
    from viscy_tpu_torch.apps.dynacell.engine import DynacellGAN

    gan = DynacellGAN(generator_config=dict(GAN_GEN), discriminator_config=dict(GAN_DISC), gan_mode="rpgan",
                      device="cpu", **GAN_REGS)
    gan.model.load_state_dict(state)
    gan.load_checkpoint_state(engine_state)
    return gan.train()


def gan_steps(inputs: dict, rows: slice) -> list[dict]:
    """``GAN_STEPS`` forward and backward passes of the narrow DynacellGAN on
    ``rows`` of the global batch, the gradients averaged over the processes
    (no optimizer step: each step sees the same weights and the advanced
    ``gan_state``): per step the loss and loss terms averaged over the
    processes, the LeCam EMAs and every gradient."""
    from viscy_tpu_torch.parallel import all_reduce_gradients_, all_reduce_mean

    gan = gan_engine(inputs["gan_state"], inputs["gan_engine_state"])
    local = {k: v[rows] for k, v in inputs["gan_batch"].items()}
    out = []
    for _ in range(GAN_STEPS):
        gan.zero_grad(set_to_none=True)
        loss = gan.training_loss(local)
        loss.backward()
        all_reduce_gradients_(gan.parameters())
        out.append({"loss": float(all_reduce_mean(loss.detach())),
                    "metrics": {k: float(all_reduce_mean(v)) for k, v in gan.last_metrics.items()},
                    "lecam": [float(gan.lecam_real), float(gan.lecam_fake)], "d_step": gan.d_step,
                    "grads": {n: p.grad.clone() for n, p in gan.named_parameters() if p.grad is not None}})
    return out


def online_eval_epoch(data: dict, rank: int) -> list:
    """One validation epoch of ``OnlineEvalCallback`` (k 5, cv) on this
    rank's rows (rank 0 the first ``split``, rank 1 the rest), fed in
    batches of 8 with their ``anchor_meta``: the metrics it logs."""
    from types import SimpleNamespace

    from viscy_tpu_torch.training.callbacks.online_eval import OnlineEvalCallback

    rows = slice(0, data["split"]) if rank == 0 else slice(data["split"], None)
    feats, meta = data["features"][rows], data["meta"][rows]
    logged: list = []
    logger = SimpleNamespace(log_metrics=lambda metrics, step: logged.append((dict(metrics), step)))
    trainer = SimpleNamespace(current_epoch=0, global_step=3, device=torch.device("cpu"), logger=logger)
    cb = OnlineEvalCallback(k=5)
    cb.on_validation_epoch_start(trainer, None)
    for i in range(0, len(meta), 8):
        cb.on_validation_batch_end(trainer, None, {"features": feats[i:i + 8]}, {"anchor_meta": meta[i:i + 8]}, i // 8)
    cb.on_validation_epoch_end(trainer, None, {})
    return logged


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
    gan_per = GAN_BATCH // world
    out["gan"] = gan_steps(inputs, slice(rank * gan_per, (rank + 1) * gan_per))
    out["online_eval"] = online_eval_epoch(inputs["online_eval"], rank)
    # the same step with each rank's own BatchNorm statistics, then with its own negatives
    with _replaced(blocks, "global_sum", lambda x: x):
        out["local_stats"] = contrastive_step(inputs["contrastive_state"], inputs["contrastive_batch"], rows)
    with _replaced(contrastive_loss, "gather_batch", lambda x: x):
        out["local_negatives"] = contrastive_step(inputs["contrastive_state"], inputs["contrastive_batch"], rows)
    torch.save(out, work / f"out{rank}.pt")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main(Path(sys.argv[1]))
