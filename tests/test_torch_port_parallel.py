"""Data parallelism across processes in the port (``viscy_tpu_torch.parallel``)
against the JAX package's one-process step on the global batch.

The JAX step is one program over the global batch: its gradient is that of
the global-mean loss, its train-mode BatchNorm normalizes by the global
batch's statistics and its NT-Xent draws negatives from the global batch.
Two port processes over gloo on the CPU (``tests/_torch_port_parallel_worker.py``,
spawned once for the module through the ``VISCY_*`` environment with a
file store under the test's temporary directory, one thread each, killed
and failed after 120 s) run, each on its half of a global batch of 8:

- two ``Trainer.fit`` steps of a narrow ``VSUNet("fcmae")`` (blocks
  (1, 1, 1, 1), dims 8-64, 1 x 5 x 32 x 32, ``MixedLoss``, AdamW) against
  two jitted JAX steps: losses, parameters and their updates;
- four steps with ``accumulate_grad_batches: 2`` and ``gradient_clip_val``
  against the port's one process on the global batches;
- one step of a narrow ``ContrastiveModule`` (BatchNorm projection,
  NT-Xent) against ``jax.value_and_grad`` of the JAX engine's loss: the
  anchor embedding and projection, the loss, every gradient and both
  running statistics; the same step with each rank's own BatchNorm
  statistics or its own negatives misses the bound;
- two forward and backward passes of a narrow ``DynacellGAN`` (LeCam, R1,
  R2 every second step and the EMA on; a global batch of 2) against the
  JAX engine's jitted step at d_step 0 and 1: the loss and each term, the
  LeCam EMAs (the same on both ranks) and every gradient;
- one validation epoch of ``OnlineEvalCallback`` on uneven shares of 46
  seeded embeddings with string labels, against the JAX callback on all
  of them: the gather before the metrics;
- ``viscy-torch fit`` of a narrow VSCyto3D config on a small plate.

Tolerances, float32: against JAX max|d| <= 2e-3 of the range with Pearson
r > 0.9999 (the port's parity bound), losses to 1e-5 relative; against the
port's own one-process run 1e-5 of the range. The sampler, the loaders and
the refusals are checked in this process, a second rank simulated by
patching the process count.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from viscy_tpu.apps.cytoland import engine as jengine
from viscy_tpu.apps.dynacell import engine as jdynacell
from viscy_tpu.apps.dynaclr import engine as jdyn
from viscy_tpu.data import loader as jloader
from viscy_tpu.data import triplet as jtriplet
from viscy_tpu.data.distributed import ShardedDistributedSampler as JSampler
from viscy_tpu.models.contrastive import loss as jloss
from viscy_tpu.models.contrastive.encoder import ContrastiveEncoder as JEncoder
from viscy_tpu.models.unet.fcmae import FullyConvolutionalMAE as JFCMAE
from viscy_tpu.training.callbacks import online_eval as jonline
from viscy_tpu.training.losses.mixed_loss import MixedLoss as JMixedLoss
from viscy_tpu_torch.apps.cytoland import engine as tengine
from viscy_tpu_torch.apps.dynacell import engine as tdynacell
from viscy_tpu_torch.apps.dynaclr import engine as tdyn
from viscy_tpu_torch.data import distributed as tdistributed
from viscy_tpu_torch.data import loader as tloader
from viscy_tpu_torch.data import triplet as ttriplet
from viscy_tpu_torch.data.distributed import ShardedDistributedSampler
from viscy_tpu_torch.parallel import distributed as pdist
from viscy_tpu_torch.parallel import mesh
from viscy_tpu_torch.training import cli
from viscy_tpu_torch.training import trainer as ttrainer
from viscy_tpu_torch.training.convert import (
    contrastive_state_dict_from_flax,
    fcmae_state_dict_from_flax,
    gan_state_dict_from_flax,
    load_flax_params,
    patchgan_state_dict_from_flax,
)
from viscy_tpu_torch.zarr_io.synthetic import build_hcs_plate

import _torch_port_parallel_worker as W
from _torch_port_helpers import assert_rel_close, flax_params, rel_err, seeded_params
from test_torch_port_gan import _bias_under_norm, _check_grads, _sn_stats

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_port_parallel_worker.py"
WORLD = 2
WATCHDOG_S = 120
# the FCMAE's 2-D stem: built by the port, never run (no JAX counterpart)
UNBRIDGED = {"encoder.stem.conv2d.weight", "encoder.stem.conv2d.bias"}
# contrastive parameters whose gradient is 0 up to rounding: a shift the next train-mode BatchNorm removes
SHIFTS = {"encoder.head.norm.bias", "projection.0.bias", "projection.3.bias"}
CHANNELS = ["Phase3D", "Nucleus", "Membrane"]
CLI_MODEL = dict(in_channels=1, out_channels=2, encoder_blocks=[1, 1, 2, 1], encoder_drop_path_rate=0.0,
                 dims=[16, 32, 64, 128], decoder_conv_blocks=2, stem_kernel_size=[5, 2, 2], in_stack_depth=5,
                 pretraining=False)


def _within(got, want, rel=2e-3, r_min=0.9999) -> bool:
    err, r = rel_err(got, want)
    return err <= rel and r > r_min


def _variables(module, seed: int, *args) -> tuple[dict, dict]:
    """Seeded numpy ``params`` and ``batch_stats`` (means N(0, 0.1),
    variances U(0.5, 1.5)) for a flax module."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.normal(0, 0.1, s.shape) if path[-1].key == "mean" else rng.uniform(0.5, 1.5, s.shape))
        .astype(np.float32),
        shapes.get("batch_stats", {}),
    )
    return seeded_params(shapes["params"], seed), stats


def _fit_config(plate: Path, root: Path, batch_size: int) -> dict:
    """A narrow VSCyto3D fit: the host weighted crop (drawn from (seed,
    epoch, index), the same in any process) and no device draw, so one
    process and two see the same patches."""
    crop = {"class_path": "viscy_tpu.data.host_transforms.HostRandWeightedCropd",
            "init_args": {"keys": CHANNELS + ["weight"], "w_key": "weight", "spatial_size": [5, 32, 32],
                          "num_samples": 2}}
    norm = {"class_path": "viscy_transforms.NormalizeSampled", "init_args": {"keys": CHANNELS, "level": "fov_statistics"}}
    model = {"class_path": "cytoland.engine.VSUNet",
             "init_args": {"architecture": "fcmae", "model_config": CLI_MODEL, "lr": 2e-4, "schedule": "WarmupCosine",
                           "warmup_steps": 1,
                           "loss_function": {"class_path": "viscy_utils.losses.MixedLoss",
                                             "init_args": {"l1_alpha": 0.5, "l2_alpha": 0.0, "ms_dssim_alpha": 0.5}}}}
    data = {"data_path": str(plate), "source_channel": "Phase3D", "target_channel": ["Nucleus", "Membrane"],
            "z_window_size": 5, "split_ratio": 0.67, "batch_size": batch_size, "num_workers": 0,
            "yx_patch_size": [32, 32], "normalizations": [norm], "augmentations": [crop]}
    return {"base": [str(ROOT / "configs/recipes/trainer/fit.yml")], "model": model,
            "data": {"class_path": "viscy_data.HCSDataModule", "init_args": data},
            "trainer": {"device": "cpu", "max_epochs": 3, "default_root_dir": str(root), "log_every_n_steps": 1}}


def _write(path: Path, cfg: dict) -> Path:
    path.write_text(yaml.safe_dump(cfg))
    return path


def _jax_fcmae(params: dict, batches: list[dict]) -> tuple[list[float], dict]:
    """Two jitted JAX steps on the global batches: the losses and the final
    parameters (as a port state dict)."""
    jmod = jengine.VSUNet("fcmae", dict(W.FCMAE, fused_mlp=False), loss_function=JMixedLoss(0.5, 0.0, 0.5),
                          **W.FCMAE_ENGINE)

    tx, _ = jmod.configure_optimizers(total_steps=len(batches))

    @jax.jit
    def step(p, state, batch):
        loss, grads = jax.value_and_grad(lambda p: jmod.training_loss({"params": p}, batch, jax.random.PRNGKey(0))[0])(p)
        upd, state = tx.update(grads, state, p)
        return loss, optax.apply_updates(p, upd), state

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    losses = []
    for b in batches:
        loss, jp, state = step(jp, state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        losses.append(float(loss))
    return losses, fcmae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp))


def _jax_contrastive(params: dict, stats: dict, batch: dict) -> dict:
    """``jax.value_and_grad`` of the JAX engine's NT-Xent loss on the global
    batch, the anchor's train-mode embedding and projection, and the
    running statistics after the step (as port state dicts)."""
    jmod = jdyn.ContrastiveModule(encoder=dict(W.CONTRASTIVE), loss_function=jloss.NTXentLoss(0.5))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    jstats = jax.tree_util.tree_map(jnp.asarray, stats)

    def loss_fn(p):
        value, (_, extra) = jmod.training_loss({"params": p, "batch_stats": jstats}, jb, key)
        emb, proj, _ = jmod.forward({"params": p, "batch_stats": jstats}, jb["anchor"], train=True,
                                    rngs={"dropout": key})
        return value, (extra["batch_stats"], emb, proj)

    (loss, (new_stats, emb, proj)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"loss": float(loss), "embedding": np.asarray(emb), "projection": np.asarray(proj),
            "grads": contrastive_state_dict_from_flax(host(grads)),
            "stats": contrastive_state_dict_from_flax({}, host(new_stats))}


def _gan_inputs() -> tuple:
    """The JAX DynacellGAN of the worker's settings, its seeded variables (a
    non-trivial ``gan_state`` and EMA), a seeded global batch, and the port
    engine's weights and engine state on those variables."""
    j = jdynacell.DynacellGAN(generator_config=dict(W.GAN_GEN), discriminator_config=dict(W.GAN_DISC),
                              gan_mode="rpgan", **W.GAN_REGS)
    rng = np.random.default_rng(40)
    batch = {"source": rng.normal(0, 1, (W.GAN_BATCH, 1, 10, 64, 64)).astype(np.float32),
             "target": rng.normal(0, 1, (W.GAN_BATCH, 2, 10, 64, 64)).astype(np.float32)}
    shapes = jax.eval_shape(lambda: j.init_with_rngs({"params": jax.random.PRNGKey(0)},
                                                      {k: jnp.asarray(v) for k, v in batch.items()}))
    variables = {"params": seeded_params(shapes["params"], 41),
                 "batch_stats": {"discriminator": _sn_stats(shapes["batch_stats"]["discriminator"], 42)},
                 "gan_state": {"d_step": np.int32(0), "lecam_real": np.float32(0.3), "lecam_fake": np.float32(-0.2),
                               "ema_generator": seeded_params(shapes["params"]["generator"], 43)}}
    t = tdynacell.DynacellGAN(generator_config=dict(W.GAN_GEN), discriminator_config=dict(W.GAN_DISC),
                              gan_mode="rpgan", device="cpu", **W.GAN_REGS)
    load_flax_params(t.model, variables["params"]["generator"])
    t.load_checkpoint_state(gan_state_dict_from_flax(t.model, variables))
    return j, variables, batch, t.model.state_dict(), t.checkpoint_state()


def _jax_gan(j, variables: dict, batch: dict) -> list[dict]:
    """The JAX engine's jitted loss and gradients at the global batch, twice,
    the second call from the first's ``gan_state`` and ``u`` (d_step 1): the
    loss and its terms, the LeCam EMAs and every gradient (port names)."""

    @jax.jit
    def step(params, rest, b):
        return jax.value_and_grad(lambda p: j.training_loss({**rest, "params": p}, b, jax.random.PRNGKey(1)),
                                  has_aux=True)(params)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rest = {k: v for k, v in variables.items() if k != "params"}
    out = []
    for _ in range(W.GAN_STEPS):
        (loss, (metrics, upd)), grads = step(variables["params"], rest, jb)
        grads = jax.tree_util.tree_map(np.asarray, grads)
        out.append({"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
                    "lecam": [float(upd["gan_state"][k]) for k in ("lecam_real", "lecam_fake")],
                    "generator": fcmae_state_dict_from_flax(grads["generator"]),
                    "discriminator": patchgan_state_dict_from_flax(grads["discriminator"])})
        rest = {"batch_stats": upd["batch_stats"], "gan_state": upd["gan_state"]}
    return out


def _spawn(work: Path) -> list[subprocess.Popen]:
    procs = []
    for rank in range(WORLD):
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        env.update(VISCY_COORDINATOR=f"file://{work / 'store'}", VISCY_NUM_PROCESSES=str(WORLD),
                   VISCY_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        log = open(work / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen([sys.executable, str(WORKER), str(work)], env=env, cwd=work, stdout=log,
                                      stderr=subprocess.STDOUT))
        log.close()
    return procs


def _join(procs: list[subprocess.Popen], work: Path, deadline: float) -> None:
    """Wait for every rank until ``deadline``; kill them all and fail with
    their logs if one is late or failed."""
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            p.kill()
            p.wait()
    logs = "\n".join(f"--- rank {r} ---\n{(work / f'rank{r}.log').read_text()[-4000:]}" for r in range(WORLD))
    if late:
        pytest.fail(f"the two-process job was still running after {WATCHDOG_S} s (killed)\n{logs}")
    if any(p.returncode for p in procs):
        pytest.fail(f"a rank failed: exit codes {[p.returncode for p in procs]}\n{logs}")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Spawn the two ranks, compute the JAX and one-process references
    meanwhile, then read the ranks' results."""
    t0 = time.monotonic()
    work = tmp_path_factory.mktemp("parallel")
    params = flax_params(JFCMAE(**W.FCMAE), 31, jnp.zeros((1, 1, 5, 32, 32)))
    fcmae = tengine.VSUNet("fcmae", dict(W.FCMAE, fused_mlp=True), device="cpu")
    load_flax_params(fcmae.model, params)
    rng = np.random.default_rng(3)
    batches = [{"source": torch.from_numpy(rng.random((W.GLOBAL_BATCH, 1, 5, 32, 32), np.float32)),
                "target": torch.from_numpy(rng.random((W.GLOBAL_BATCH, 2, 5, 32, 32), np.float32))} for _ in range(4)]
    cparams, cstats = _variables(JEncoder(**W.CONTRASTIVE), 19, jnp.zeros((1, 2, 10, 64, 64)))
    contrastive = tdyn.ContrastiveModule(encoder=dict(W.CONTRASTIVE), device="cpu")
    load_flax_params(contrastive.model, cparams, cstats)
    cbatch = {k: torch.from_numpy(np.random.default_rng(20 + i).random((W.GLOBAL_BATCH, 2, 10, 64, 64), np.float32))
              for i, k in enumerate(("anchor", "positive"))}
    hrng = np.random.default_rng(21)
    y = hrng.normal(0, 1, (W.GLOBAL_BATCH, 5)).astype(np.float32)
    y[[1, 6]] = np.nan  # unpaired rows, one on each rank
    head_batch = {"x": torch.from_numpy(hrng.normal(0, 1, (W.GLOBAL_BATCH, 32)).astype(np.float32)),
                  "y": torch.from_numpy(y)}
    jgan, gan_vars, gan_batch, gan_state, gan_engine_state = _gan_inputs()
    orng = np.random.default_rng(45)
    markers = orng.choice(["CAAX", "H2B", "SEC61B"], 46)
    centers = {m: orng.normal(0, 1, 16) for m in ("CAAX", "H2B", "SEC61B")}
    online = {"split": 20, "features": torch.from_numpy(np.stack([centers[m] + orng.normal(0, 1.2, 16)
                                                                  for m in markers]).astype(np.float32)),
              "meta": [{"marker": str(m), "track_id": i // 4, "t": 2 * (i % 4)} for i, m in enumerate(markers)]}
    inputs = {"fcmae_state": fcmae.model.state_dict(), "fcmae_batches": batches,
              "contrastive_state": contrastive.model.state_dict(), "contrastive_batch": cbatch,
              "head_batch": head_batch, "gan_state": gan_state, "gan_engine_state": gan_engine_state,
              "gan_batch": {k: torch.from_numpy(v) for k, v in gan_batch.items()}, "online_eval": online}
    torch.save(inputs, work / "inputs.pt")
    plate = build_hcs_plate(work / "plate.zarr", CHANNELS, zyx_shape=(6, 48, 48), num_timepoints=1, rows=("A",),
                            cols=("1",), fovs=("0", "1", "2"), seed=5)
    cli.main(["preprocess", "-c", str(_write(work / "pp.yml", {"data_path": str(plate), "num_workers": 1}))])
    # each rank's batch is half the one-process batch
    _write(work / "fit_world2.yml", _fit_config(plate, work / "cli_world2", batch_size=4))
    _write(work / "fit_world1.yml", _fit_config(plate, work / "cli_world1", batch_size=8))
    procs = _spawn(work)
    try:
        ref = {
            "jax_fcmae": _jax_fcmae(params, batches[:2]),
            "jax_contrastive": _jax_contrastive(cparams, cstats, cbatch),
            "jax_gan": _jax_gan(jgan, gan_vars, gan_batch),
            "fcmae": W.fcmae_fit(inputs["fcmae_state"], batches[:2], slice(None), work / "fcmae_world1"),
            "accumulate": W.fcmae_fit(inputs["fcmae_state"], batches, slice(None), work / "accumulate_world1",
                                      accumulate_grad_batches=2, gradient_clip_val=W.CLIP),
            "contrastive": W.contrastive_step(inputs["contrastive_state"], cbatch, slice(None)),
            "head": W.head_step(head_batch, slice(None)),
            "init": inputs,
        }
        cli.main(["fit", "-c", str(work / "fit_world1.yml")])
    finally:
        _join(procs, work, t0 + WATCHDOG_S)
    ranks = [torch.load(work / f"out{r}.pt", weights_only=True) for r in range(WORLD)]
    print(f"two-process job and references: {time.monotonic() - t0:.1f} s")
    return work, ranks, ref


# -- the sampler and the loaders ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [1, 5, 16, 33])
def test_sampler_index_streams_equal_jax(length, replicas, drop_last, shuffle):
    """Every rank's stream, at two seeds and two epochs, equals the JAX
    sampler's element for element; the ranks together cover the index
    space (padded by wrapping without ``drop_last``)."""
    for seed in (0, 7):
        for epoch in (0, 3):
            streams = []
            for rank in range(replicas):
                kw = dict(num_replicas=replicas, rank=rank, shuffle=shuffle, seed=seed, drop_last=drop_last)
                ours, theirs = ShardedDistributedSampler(length, **kw), JSampler(length, **kw)
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                assert list(ours) == list(theirs) and len(ours) == len(theirs)
                streams.append(list(ours))
            assert len({len(s) for s in streams}) == 1
            if not drop_last:
                assert set().union(*streams) == set(range(length))


class _Items:
    def __init__(self, n: int) -> None:
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return {"x": np.asarray([i], np.int64)}


def test_loader_attaches_the_sampler_only_with_several_processes(monkeypatch):
    """One process: no sampler, the batches as before (bit for bit the JAX
    loader's). Two: each rank's ``ShardedDistributedSampler``, the batches
    equal the JAX loader's under two JAX processes, ``set_epoch`` reaches
    the sampler; ``distributed=False`` opts out."""
    ds = _Items(23)
    kw = dict(batch_size=3, shuffle=True, drop_last=True, seed=4, num_workers=0)
    one = tloader.DataLoader(ds, **kw)
    assert one.sampler is None and one._batches() == jloader.DataLoader(ds, **kw)._batches()
    monkeypatch.setattr(tloader, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for rank in range(2):
        monkeypatch.setattr(tdistributed, "process_count", lambda: 2)
        monkeypatch.setattr(tdistributed, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        ours, theirs = tloader.DataLoader(ds, **kw), jloader.DataLoader(ds, **kw)
        assert isinstance(ours.sampler, ShardedDistributedSampler) and ours.sampler.rank == rank
        for epoch in (0, 2):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert ours.sampler.epoch == epoch
            assert ours._batches() == theirs._batches()
        assert [b["x"][:, 0].tolist() for b in ours] == ours._batches()
        assert tloader.DataLoader(ds, distributed=False, **kw).sampler is None


class _Cells:
    def __init__(self, n: int) -> None:
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitems__(self, idx: list) -> list:
        return [int(i) for i in idx]


@pytest.mark.parametrize("n", [26, 5])
def test_triplet_loader_ranks_split_the_one_process_batch(monkeypatch, n):
    """Rank ``r`` yields rows ``[r * B, (r + 1) * B)`` of each batch the JAX
    loader draws in one process with batch ``B x 2``: the ranks' batches
    concatenated are that batch (a dataset smaller than a global batch:
    one short batch, padded by wrapping to split evenly)."""
    ds, b = _Cells(n), 3
    want = list(jtriplet._BatchedTripletLoader(ds, b * 2, shuffle=True, seed=5, epoch=2))
    per_rank = []
    for rank in range(2):
        monkeypatch.setattr(ttriplet, "process_count", lambda: 2)
        monkeypatch.setattr(ttriplet, "process_index", lambda r=rank: r)
        loader = ttriplet._BatchedTripletLoader(ds, b, shuffle=True, seed=5, epoch=2)
        per_rank.append(list(loader))
        assert len(loader) == len(want)
    for step, batch in enumerate(want):
        joined = per_rank[0][step] + per_rank[1][step]
        assert joined[: len(batch)] == batch and len(per_rank[0][step]) == len(per_rank[1][step])


def test_jax_triplet_loader_reads_the_same_cells_on_every_process(monkeypatch):
    """The fault in the JAX package the port does not copy (ROADMAP.md Queue
    3): ``viscy_tpu/data/triplet.py``'s ``_BatchedTripletLoader`` ignores
    the process count, so every process reads the same cells and the
    global batch of a two-process job holds each cell twice."""
    ds = _Cells(24)
    streams = []
    for rank in range(2):
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        streams.append(list(jtriplet._BatchedTripletLoader(ds, 4, shuffle=True, seed=1)))
    assert streams[0] == streams[1]
    global_batch = streams[0][0] + streams[1][0]
    assert len(set(global_batch)) == len(global_batch) // 2


# -- the process group's environment -----------------------------------------------------------------------


def test_environment_contract():
    """``VISCY_*`` first (``host:port`` or a ``file://`` store), then
    torchrun's variables, else one process (no group is started)."""
    assert pdist._contract({"VISCY_COORDINATOR": "h:1234", "VISCY_NUM_PROCESSES": "4", "VISCY_PROCESS_ID": "2",
                            "RANK": "0", "WORLD_SIZE": "8", "MASTER_PORT": "1"}) == ("tcp://h:1234", 4, 2, 2)
    assert pdist._contract({"VISCY_COORDINATOR": "file:///s", "VISCY_NUM_PROCESSES": "2", "VISCY_PROCESS_ID": "1",
                            "LOCAL_RANK": "0"}) == ("file:///s", 2, 1, 0)
    assert pdist._contract({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "n0",
                            "MASTER_PORT": "29500"}) == ("tcp://n0:29500", 4, 3, 1)
    assert pdist._contract({}) is None
    with pytest.raises(ValueError, match="outside"):
        pdist._contract({"VISCY_COORDINATOR": "h:1", "VISCY_NUM_PROCESSES": "2", "VISCY_PROCESS_ID": "2"})
    assert pdist.maybe_initialize(env={}, device="cpu") is False
    assert pdist.process_count() == 1 and pdist.process_index() == 0 and pdist.is_rank_zero()
    # without a group every collective is the identity
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.gather_batch(x) is x and mesh.global_sum(x) is x and mesh.all_reduce_mean(x) is x
    assert mesh.local_batch_slice(10) == slice(0, 10)


# -- two processes against JAX and against one process -----------------------------------------------------


def test_fcmae_fit_in_two_processes_matches_two_jax_steps(job):
    """Losses, parameters and updates after two steps on the global batch:
    within the parity bound of JAX's and within 1e-5 of the range of the
    port's own one process; both ranks hold the same weights."""
    _, ranks, ref = job
    jlosses, jparams = ref["jax_fcmae"]
    got = ranks[0]["fcmae"]
    init = ref["init"]["fcmae_state"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    np.testing.assert_allclose(got["losses"], ref["fcmae"]["losses"], rtol=1e-6)
    assert ranks[1]["fcmae"]["losses"] is None  # rank 1 writes no metrics.csv
    for name, p in got["params"].items():
        assert torch.equal(p, ranks[1]["fcmae"]["params"][name]), name
        if name in UNBRIDGED:
            continue
        assert_rel_close(p.numpy(), jparams[name].numpy(), 2e-3, 0.9999)
        assert_rel_close(p.numpy(), ref["fcmae"]["params"][name].numpy(), 1e-5)
        if p.numel() > 1:
            update, want = (p - init[name]).numpy(), (jparams[name] - init[name]).numpy()
            assert np.abs(want).max() > 0 and rel_err(update, want)[1] > 0.999, name


def test_accumulation_and_clipping_act_on_the_reduced_gradient(job):
    """Four steps with ``accumulate_grad_batches: 2`` and a clip far below
    the gradient norm: two processes end where one process on the global
    batches ends (1e-5 of the range), and the weights moved."""
    _, ranks, ref = job
    got, want, init = ranks[0]["accumulate"], ref["accumulate"], ref["init"]["fcmae_state"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    for name, p in got["params"].items():
        assert torch.equal(p, ranks[1]["accumulate"]["params"][name]), name
        assert_rel_close(p.numpy(), want["params"][name].numpy(), 1e-5)
        if name not in UNBRIDGED:
            assert not torch.equal(p, init[name]), name


def _contrastive_holds(ranks: list[dict], want: dict, key: str) -> dict[str, bool]:
    """Which parts of the two ranks' contrastive step ``key`` are within the
    bound of ``want``: the loss (1e-5 relative), the anchor's embedding and
    projection (both ranks' rows), every gradient (rank 0's, reduced) and
    the running statistics."""
    got = ranks[0][key]
    rows = lambda part: torch.cat([r[key][part] for r in ranks]).numpy()
    grads_ok = True
    for name, g in got["grads"].items():
        w = want["grads"][name].numpy()
        if name in SHIFTS:
            scale = np.abs(got["grads"][name.replace("bias", "weight")].numpy()).max()
            grads_ok &= bool(np.abs(g.numpy()).max() < 1e-5 * scale)
        else:
            grads_ok &= _within(g.numpy(), w)
    return {
        "loss": all(abs(r[key]["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]) for r in ranks),
        "embedding": _within(rows("embedding"), np.asarray(want["embedding"])),
        "projection": _within(rows("projection"), np.asarray(want["projection"])),
        "grads": grads_ok,
        "stats": all(_within(got["stats"][k].numpy(), v.numpy()) for k, v in want["stats"].items()),
    }


def test_contrastive_step_in_two_processes_matches_jax(job):
    """Global BatchNorm statistics and global NT-Xent negatives: embedding,
    projection, loss, every gradient and both running statistics within the
    bound of JAX's step on the global batch and of the port's one process;
    the ranks' running statistics are equal."""
    _, ranks, ref = job
    assert all(_contrastive_holds(ranks, ref["jax_contrastive"], "contrastive").values())
    assert all(_contrastive_holds(ranks, ref["contrastive"], "contrastive").values())
    for k, v in ranks[0]["contrastive"]["stats"].items():
        assert torch.equal(v, ranks[1]["contrastive"]["stats"][k]), k
        assert_rel_close(v.numpy(), ref["contrastive"]["stats"][k].numpy(), 1e-5)
    for name, g in ranks[0]["contrastive"]["grads"].items():
        assert torch.equal(g, ranks[1]["contrastive"]["grads"][name]), name


def test_cross_modal_head_takes_the_global_batch(job):
    """The auxiliary cross-modal InfoNCE head (its negatives and its count
    of paired rows from the batch) in two processes: the one-process loss
    and gradients on the global batch, within 1e-5 of the range."""
    _, ranks, ref = job
    for r in ranks:
        assert abs(r["head"]["loss"] - ref["head"]["loss"]) <= 1e-6 * abs(ref["head"]["loss"])
    for name, g in ranks[0]["head"]["grads"].items():
        assert torch.equal(g, ranks[1]["head"]["grads"][name]), name
        assert_rel_close(g.numpy(), ref["head"]["grads"][name].numpy(), 1e-5, 0.9999)


def test_local_statistics_or_local_negatives_miss_the_bound(job):
    """The same two-process step with each rank's own BatchNorm statistics,
    or with each rank's own negatives, is a different model: it misses the
    bound of JAX's global step."""
    _, ranks, ref = job
    local_stats = _contrastive_holds(ranks, ref["jax_contrastive"], "local_stats")
    assert not local_stats["stats"] and not local_stats["loss"], local_stats
    local_negatives = _contrastive_holds(ranks, ref["jax_contrastive"], "local_negatives")
    assert not local_negatives["loss"] and not local_negatives["grads"], local_negatives
    assert local_negatives["stats"]  # the BatchNorms were global there


def test_cli_fit_in_two_processes(job):
    """``viscy-torch fit`` of a narrow VSCyto3D config at two processes of
    half the batch: disjoint training reads that together are the
    one-process epoch, one checkpoint tree and one ``metrics.csv`` (rank
    0's), and the one-process run's loss curve."""
    work, ranks, _ = job
    train = [{i for shuffled, i in r["reads"] if shuffled} for r in ranks]
    assert train[0] and train[1] and not train[0] & train[1]
    assert train[0] | train[1] == set(range(4))  # two train FOVs of two windows
    lines = {w: [json.loads(s) for s in (work / f"cli_world{w}" / "metrics.csv").read_text().splitlines()]
             for w in (1, 2)}
    assert [sorted(x) for x in lines[2]] == [sorted(x) for x in lines[1]]
    curve = lambda w: [x[k] for x in lines[w] for k in ("loss/train", "loss/validate") if k in x]
    assert len(curve(1)) == 6
    np.testing.assert_allclose(curve(2), curve(1), rtol=1e-5)
    ckpts = lambda w: sorted(p.name for p in (work / f"cli_world{w}" / "checkpoints").iterdir())
    assert ckpts(2) == ckpts(1) and "last" in ckpts(2)
    assert (work / "cli_world2" / "hparams.yaml").exists()


# -- refusals ---------------------------------------------------------------------------------------------------


def test_predict_refuses_several_processes(monkeypatch):
    monkeypatch.setattr(ttrainer, "process_count", lambda: 2)
    trainer = ttrainer.Trainer(device="cpu", default_root_dir="unused")
    with pytest.raises(NotImplementedError, match="one process per output store"):
        trainer.predict(None, None)


@pytest.mark.parametrize("term,kw", [("LeCam", dict(lecam_gamma=0.1)), ("R1 / R2", dict(r1_gamma=1.0)),
                                     ("R1 / R2", dict(r2_gamma=1.0))])
def test_gan_terms_that_couple_samples_are_refused_by_name(monkeypatch, term, kw):
    """These terms were once refused under several processes; now they are
    the global batch's. Two ranks holding the same rows are
    simulated in this process (the process count 2, a global sum that
    doubles, as two equal ranks' sum does, forward and backward): the
    rank's loss, terms, LeCam EMAs and gradients equal one process's on the
    rows twice over, within 1e-5 (of the range). Without the division of
    the inner gradient by the process count, R1 / R2 come out 4x."""
    state = None

    def engine():
        gan = tdynacell.DynacellGAN(generator_config=dict(W.GAN_GEN), discriminator_config=dict(W.GAN_DISC),
                                    gan_mode="rpgan", device="cpu", r1_every=1, **kw)
        if state is not None:
            gan.model.load_state_dict(state[0])
            gan.load_checkpoint_state(state[1])
        return gan.train()

    def step(gan, batch):
        gan.zero_grad(set_to_none=True)
        loss = gan.training_loss(batch)
        loss.backward()
        return (float(loss), {k: float(v) for k, v in gan.last_metrics.items()},
                [float(gan.lecam_real), float(gan.lecam_fake)], {n: p.grad for n, p in gan.named_parameters()})

    first = engine()
    first.lecam_real, first.lecam_fake = torch.tensor(0.3), torch.tensor(-0.2)
    state = first.model.state_dict(), first.checkpoint_state()
    rng = np.random.default_rng(44)
    half = {"source": torch.from_numpy(rng.normal(0, 1, (1, 1, 10, 64, 64)).astype(np.float32)),
            "target": torch.from_numpy(rng.normal(0, 1, (1, 2, 10, 64, 64)).astype(np.float32))}
    one = step(engine(), {k: torch.cat([v, v]) for k, v in half.items()})
    monkeypatch.setattr(tdynacell, "process_count", lambda: 2)
    monkeypatch.setattr(tdynacell, "data_parallel", lambda: True)
    monkeypatch.setattr(tdynacell, "global_sum", lambda x: 2 * x)
    two = step(engine(), half)
    np.testing.assert_allclose(two[0], one[0], rtol=1e-5)
    assert two[1].keys() == one[1].keys() and (term != "R1 / R2" or {"loss/r1", "loss/r2"} & set(one[1]))
    for k in one[1]:
        np.testing.assert_allclose(two[1][k], one[1][k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(two[2], one[2], rtol=1e-5)
    for name, g in one[3].items():
        got = two[3][name]
        if g is None:
            assert got is None, name
        elif _bias_under_norm(name):  # 0 up to rounding on both sides
            scale = float(one[3][name[:-4] + "weight"].abs().max())
            assert max(float(got.abs().max()), float(g.abs().max())) < 1e-3 * scale, name
        elif g.numel() == 1:
            assert abs(float(got) - float(g)) <= 1e-5 * abs(float(g)), name
        else:
            assert_rel_close(got.numpy(), g.numpy(), 1e-5)
    if term == "R1 / R2":
        monkeypatch.setattr(tdynacell, "process_count", lambda: 1)  # the inner gradient left undivided
        unscaled = step(engine(), half)
        key = "loss/r1" if "r1_gamma" in kw else "loss/r2"
        np.testing.assert_allclose(unscaled[1][key], 4 * one[1][key], rtol=1e-5)


def test_gan_regularizers_over_two_ranks_match_jax_at_the_global_batch(job):
    """Two ranks, each on half of a global batch of 2, with LeCam, R1, R2
    (every second step) and the EMA on, against the JAX engine's step at
    the global batch: at d_step 0 (R1 / R2 applied) and d_step 1 (not),
    the loss and its terms (R1 / R2 global on each rank: the inner gradient
    of the global mean logit divided by the process count), the LeCam EMAs
    (global means: the same on both ranks) and every gradient."""
    _, ranks, ref = job
    for step, want in enumerate(ref["jax_gan"]):
        r0, r1 = ranks[0]["gan"][step], ranks[1]["gan"][step]
        assert r0["lecam"] == r1["lecam"] and r0["d_step"] == r1["d_step"] == step + 1
        assert ("loss/r1" in r0["metrics"]) == (step == 0) and ("loss/r1" in want["metrics"])
        np.testing.assert_allclose(r0["loss"], want["loss"], rtol=1e-5)
        for k, v in r0["metrics"].items():
            np.testing.assert_allclose(v, want["metrics"][k], rtol=2e-4, err_msg=k)
        np.testing.assert_allclose(r0["lecam"], want["lecam"], rtol=1e-5)
        grads = r0["grads"]
        _check_grads({k[len("discriminator."):]: grads.get(k) for k in
                      (f"discriminator.{n}" for n in want["discriminator"])}, want["discriminator"])
        for k, w in want["generator"].items():
            assert_rel_close(grads[f"model.{k}"].numpy(), w.numpy(), 2e-3, 0.9999)
        assert all(torch.equal(g, ranks[1]["gan"][step]["grads"][n]) for n, g in grads.items())


def test_online_eval_gathers_every_rank_before_its_metrics(job):
    """Ranks holding 20 and 26 of 46 embeddings (string labels encoded by a
    vocabulary both ranks share, then decoded): each logs what the JAX
    callback logs in one process on all 46 (k-NN equal, effective rank and
    temporal smoothness within 1e-9 relative)."""
    _, ranks, ref = job
    data = ref["init"]["online_eval"]
    feats, meta = data["features"].numpy(), data["meta"]
    logged: list = []
    trainer = type("T", (), {"current_epoch": 0, "global_step": 3})()
    trainer.logger = type("L", (), {"log_metrics": lambda self, m, s: logged.append((dict(m), s))})()
    cb = jonline.OnlineEvalCallback(k=5)
    cb.on_validation_epoch_start(trainer, None)
    for i in range(0, len(meta), 8):
        cb.on_validation_batch_end(trainer, None, {"features": feats[i:i + 8]}, {"anchor_meta": meta[i:i + 8]}, i // 8)
    cb.on_validation_epoch_end(trainer, None, {})
    assert len(logged[0][0]) == 3
    for r in ranks:
        got = r["online_eval"]
        assert [(sorted(m), s) for m, s in got] == [(sorted(m), s) for m, s in logged]
        for (g, _), (w, _) in zip(got, logged):
            for k, v in w.items():
                assert (g[k] == v) if "knn" in k else abs(g[k] - v) <= 1e-9 * abs(v), k


def test_fov_shard_stays_refused():
    with pytest.raises(NotImplementedError, match="fov_shard"):
        tengine.VSUNet("fcmae", dict(W.FCMAE), fov_shard=True, device="cpu")
