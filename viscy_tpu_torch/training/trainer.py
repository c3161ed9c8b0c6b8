"""Trainer (counterpart of ``viscy_tpu/training/trainer.py``): the fit loop
with validation, checkpoints and the CSV logger, ``validate`` and the
predict loop.

PyTorch runs eagerly, so there is no compiled step. Batches reach the
device through :class:`BatchPrefetcher`: a producer thread walks the host
loader, copies each batch into reused pinned buffers and onto the device
on a side stream, so the copy overlaps the previous step. A fit step runs
the datamodule's device transform with the trainer's seeded
``torch.Generator``, then ``training_loss`` (its stochastic depth and
any token masks drawn from a second generator) and ``backward``; every
``accumulate_grad_batches`` steps the (mean) gradient is clipped and AdamW
and its scheduler step. ``test`` runs the engine's test step over the test
loader and means its metrics. Metrics go to ``metrics.csv``, a TensorBoard
event file and any extra sinks (W&B).

Data parallelism across processes (the JAX trainer's ``data`` axis): under
a ``torch.distributed`` process group
(:func:`viscy_tpu_torch.parallel.maybe_initialize`) each process trains on
its loader's rows, rank 0's weights are broadcast at the fit's start, the
gradient is averaged over the processes after accumulation and before
clipping, the rank is folded into the seeds of the device generators,
validation and test metrics are averaged over the processes, and only rank
0 writes checkpoints and logs. ``predict`` runs in one process only.
FSDP, tensor and pipeline parallelism are not ported.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from viscy_tpu_torch.device import resolve_device
from viscy_tpu_torch.parallel.distributed import is_rank_zero, process_count, process_index
from viscy_tpu_torch.parallel.mesh import all_reduce_gradients_, all_reduce_mean, barrier, broadcast_module_
from viscy_tpu_torch.training.callbacks.base import Callback
from viscy_tpu_torch.training.module import TrainModule
from viscy_tpu_torch.training.optimizers import clip_by_global_norm_, clip_by_value_
from viscy_tpu_torch.training.tb_events import EventFileWriter

_logger = logging.getLogger("viscy_tpu_torch")


_STOP = object()  # prefetch-queue sentinel

# seed offset between the device generators of consecutive ranks
RANK_SEED_STRIDE = 1 << 40


class _Slot:
    """One ring entry: pinned host buffers by leaf path, and the event of
    the last copy out of them."""

    def __init__(self) -> None:
        self.buffers: dict[tuple, torch.Tensor] = {}
        self.event: torch.cuda.Event | None = None


class BatchPrefetcher:
    """Iterate ``loader``'s batches on ``device``, ``depth`` batches ahead.

    A producer thread takes each host batch (numpy arrays and CPU tensors,
    nested dicts such as ``norm_meta`` too; other leaves pass as they are)
    and, for a CUDA device, copies every array into a ring of pinned host
    buffers that are reused while the shapes stay the same (a new shape,
    such as a validation batch, gets a new buffer), then onto the device on
    a side copy stream, recording an event. The consumer's stream waits on
    that event before the batch is used, and each device tensor is marked
    as used by the consumer's stream (``record_stream``), so its memory is
    not handed out again while the step still reads it. A ring buffer is
    refilled only after its last copy has completed. On the CPU the arrays
    become tensors without a copy. ``limit`` stops after that many batches;
    ``wait_s`` counts the seconds the consumer waited for a batch.
    """

    def __init__(self, loader, device: torch.device, limit: int | None = None, depth: int = 2) -> None:
        self.loader = loader
        self.device = device
        self.limit = limit
        self.depth = max(1, depth)
        self.wait_s = 0.0
        self.batches = 0

    def _stage(self, node, slot: _Slot | None, path: tuple = ()):
        if isinstance(node, dict):
            return {k: self._stage(v, slot, path + (k,)) for k, v in node.items()}
        if isinstance(node, np.ndarray) and node.dtype != object:
            node = torch.from_numpy(np.ascontiguousarray(node))
        if not isinstance(node, torch.Tensor) or slot is None or node.device.type != "cpu":
            return node
        buf = slot.buffers.get(path)
        if buf is None or buf.shape != node.shape or buf.dtype != node.dtype:
            buf = slot.buffers[path] = torch.empty(node.shape, dtype=node.dtype, pin_memory=True)
        buf.copy_(node)
        out = torch.empty(node.shape, dtype=node.dtype, device=self.device)
        out.copy_(buf, non_blocking=True)
        return out

    def __iter__(self):
        import queue
        import threading

        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        ring = [_Slot() for _ in range(self.depth + 2)] if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            it = None
            try:
                it = iter(self.loader)
                for i, batch in enumerate(it):
                    if stop.is_set() or (self.limit is not None and i >= self.limit):
                        break
                    if not cuda:
                        item = (self._stage(batch, None), None)
                    else:
                        slot = ring[i % len(ring)]
                        if slot.event is not None:
                            slot.event.synchronize()
                        with torch.cuda.device(self.device), torch.cuda.stream(stream):
                            staged = self._stage(batch, slot)
                            slot.event = torch.cuda.Event()
                            slot.event.record(stream)
                        item = (staged, slot.event)
                    if not put(item):
                        break
            except Exception as e:  # surfaces in the consumer
                put(e)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                put(_STOP)

        t = threading.Thread(target=producer, daemon=True, name="viscy-prefetch")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_s += time.perf_counter() - t0
                if item is _STOP:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    _record_stream(batch, current)
                self.batches += 1
                yield batch
        finally:
            stop.set()
            t.join()


def _record_stream(node, stream) -> None:
    if isinstance(node, dict):
        for v in node.values():
            _record_stream(v, stream)
    elif isinstance(node, torch.Tensor) and node.device.type == "cuda":
        node.record_stream(stream)


class CSVLogger:
    """Metrics sinks: ``<log_dir>/metrics.csv``, one JSON line
    ``{"step": step, <metric>: value, ...}`` per logged step, and with
    ``use_tensorboard`` a TensorBoard event file in ``log_dir``
    (:mod:`viscy_tpu_torch.training.tb_events`), each opened at the first
    line; ``extra`` sinks (such as the env-gated W&B logger,
    :class:`viscy_tpu_torch.training.loggers.WandbLogger`) take the same
    ``log_metrics`` / ``log_image`` / ``close`` calls, and a failing one
    never stops training. ``log_image`` writes an (H, W, 3) image into the
    event file."""

    def __init__(self, log_dir: str | Path, use_tensorboard: bool = True, extra: Sequence | None = None) -> None:
        self.log_dir = Path(log_dir)
        self.use_tensorboard = use_tensorboard
        self.extra = list(extra or [])
        self._csv = None
        self._tb: EventFileWriter | None = None

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        if self._csv is None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._csv = open(self.log_dir / "metrics.csv", "a")
            if self.use_tensorboard and self._tb is None:
                self._tb = EventFileWriter(self.log_dir)
        values = {k: float(v) for k, v in metrics.items()}
        self._csv.write(json.dumps({"step": step, **values}) + "\n")
        self._csv.flush()
        if self._tb is not None:
            self._tb.add_scalars(values, step)
        for sink in self.extra:
            try:
                sink.log_metrics(values, step)
            except Exception:  # an observability sink never stops training
                _logger.warning("metrics sink %r failed", sink, exc_info=True)

    def log_image(self, tag: str, image, step: int) -> None:
        """An (H, W, 3) image into the event file (opened here if no metric
        came first) and the extra sinks."""
        if self.use_tensorboard and self._tb is None:
            self._tb = EventFileWriter(self.log_dir)
        if self._tb is not None:
            self._tb.add_image(tag, image, step)
        for sink in self.extra:
            try:
                sink.log_image(tag, image, step)
            except Exception:  # an observability sink never stops training
                _logger.warning("image sink %r failed", sink, exc_info=True)

    def close(self) -> None:
        if self._csv is not None:
            self._csv.close()
            self._csv = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        for sink in self.extra:
            try:
                sink.close()
            except Exception:
                _logger.warning("metrics sink %r failed to close", sink, exc_info=True)


class _NullLogger:
    """The metric sinks of a rank other than 0: nothing is written."""

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        pass

    def log_image(self, tag: str, image, step: int) -> None:
        pass

    def close(self) -> None:
        pass


def _mean_over_ranks(metrics: dict[str, float], device: torch.device) -> dict[str, float]:
    """Each metric's mean over the processes (every rank holds the same keys)."""
    if not metrics or process_count() == 1:
        return metrics
    keys = sorted(metrics)
    values = all_reduce_mean(torch.tensor([metrics[k] for k in keys], dtype=torch.float64, device=device))
    return dict(zip(keys, values.tolist()))


class Trainer:
    """Drives TrainModule engines over DataModules on one device per process.

    - ``max_steps`` ends the fit (and sets the schedule's length); without
      it the fit runs ``max_epochs`` passes over ``train_dataloader()``
      (at most ``limit_train_batches`` batches each), whose length (or the
      datamodule's ``steps_per_epoch``) sets the schedule.
    - Every ``log_every_n_steps`` steps ``metrics.csv`` and
      ``logged_metrics`` take the step's loss, the learning rate at
      ``global_step`` and the mean step time (reading the loss waits for
      the device).
    - Every ``check_val_every_n_epoch`` epochs ``val_dataloader()`` (at most
      ``limit_val_batches`` batches) runs ``validation_loss`` in eval mode;
      its mean ``loss/validate`` is logged. Validation draws its device
      transforms from a generator of its own, so the training augmentation
      stream does not depend on it.
    - Every ``checkpoint_every_n_epochs`` epochs a checkpoint goes to
      ``<default_root_dir>/checkpoints/epoch=E-step=S[-loss=L]`` (``L``
      the ``checkpoint_monitor`` value), ``last`` links to it, and only the
      ``checkpoint_top_k`` lowest monitored ones are kept (never ``last``'s
      target). ``fit(..., ckpt_path=...)`` resumes from one.
    - ``gradient_clip_val`` clips the gradient before AdamW, by global norm
      (``optax.clip_by_global_norm``) or by value (``optax.clip``);
      ``accumulate_grad_batches = k`` applies the mean gradient of k steps
      every k steps (``optax.MultiSteps``): ``global_step`` counts steps,
      AdamW and the schedule count updates.
    - ``profile_dir``: a ``torch.profiler`` trace of steps
      ``profile_steps[0]`` to ``profile_steps[1]``, written there.
    - ``fast_dev_run``: one epoch of one train and one val batch, every
      step logged, no checkpoint.
    - ``use_tensorboard`` adds a TensorBoard event file beside
      ``metrics.csv``; ``loggers`` are extra metric sinks (the CLI maps
      ``trainer.logger`` to them).

    The augmentation generator is seeded with ``seed + 1`` at every fit
    start, the stochastic-depth generator with ``seed + 2**32``; rank ``r``
    of a job of several processes adds ``r * RANK_SEED_STRIDE`` to these
    and to the validation seeds, so no two ranks draw the same
    augmentation. In such a job only rank 0 writes ``metrics.csv``, the
    event file, the extra sinks, the checkpoints and the profile.
    """

    def __init__(
        self,
        max_epochs: int = 1,
        max_steps: int | None = None,
        callbacks: Sequence[Callback] | None = None,
        default_root_dir: str | Path = "lightning_logs",
        fast_dev_run: bool = False,
        limit_train_batches: int | None = None,
        limit_val_batches: int | None = None,
        log_every_n_steps: int = 10,
        checkpoint_every_n_epochs: int = 1,
        checkpoint_monitor: str = "loss/validate",
        checkpoint_top_k: int = 5,
        seed: int = 42,
        use_tensorboard: bool = True,
        loggers: Sequence | None = None,
        gradient_clip_val: float | None = None,
        gradient_clip_algorithm: str = "norm",
        accumulate_grad_batches: int = 1,
        check_val_every_n_epoch: int = 1,
        profile_dir: str | None = None,
        profile_steps: tuple[int, int] = (10, 15),
        device: str | torch.device = "cuda",
    ) -> None:
        if gradient_clip_algorithm not in ("norm", "value"):
            raise ValueError(f"gradient_clip_algorithm must be 'norm' or 'value', got {gradient_clip_algorithm!r}")
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.callbacks = list(callbacks or [])
        self.default_root_dir = Path(default_root_dir)
        self.fast_dev_run = fast_dev_run
        self.limit_train_batches = 1 if fast_dev_run else limit_train_batches
        self.limit_val_batches = 1 if fast_dev_run else limit_val_batches
        self.log_every_n_steps = log_every_n_steps
        self.checkpoint_every_n_epochs = checkpoint_every_n_epochs
        self.checkpoint_monitor = checkpoint_monitor
        self.checkpoint_top_k = checkpoint_top_k
        self.seed = seed
        self.gradient_clip_val = gradient_clip_val
        self.gradient_clip_algorithm = gradient_clip_algorithm
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches or 1))
        self.check_val_every_n_epoch = max(1, int(check_val_every_n_epoch or 1))
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.device = resolve_device(device)
        self.is_rank_zero = is_rank_zero()
        if self.is_rank_zero:
            self.logger = CSVLogger(self.default_root_dir, use_tensorboard, extra=loggers)
        else:
            self.logger = _NullLogger()
        self.optimizer = None
        self.scheduler = None
        self._schedule = None
        self.generator: torch.Generator | None = None
        self._pretrained_loaded = False
        self.current_epoch = 0
        self.global_step = 0
        self.logged_metrics: dict[str, float] = {}
        self._ckpt_scores: list[tuple[float, str]] = []
        # optax.MultiSteps state: the mini-step and the running mean gradient
        self._mini_step = 0
        self._acc: dict[str, torch.Tensor] = {}
        self._profiler = None
        self._active_datamodule = None
        # train-loop totals over fits: steps, wall seconds, seconds waited
        # for a batch
        self.feed_stats = {"steps": 0, "seconds": 0.0, "wait_s": 0.0}

    # -- helpers ----------------------------------------------------------------
    def _total_steps(self, datamodule, loader) -> int:
        try:
            steps_per_epoch = len(loader)
        except TypeError:
            steps_per_epoch = getattr(datamodule, "steps_per_epoch", None)
            if steps_per_epoch is None and not self.max_steps:
                raise ValueError(
                    "train_dataloader has no len() and the datamodule defines no "
                    "steps_per_epoch: set one of them or Trainer(max_steps=...)"
                ) from None
        if self.max_steps:
            return self.max_steps
        if self.limit_train_batches:
            steps_per_epoch = min(steps_per_epoch, self.limit_train_batches)
        return steps_per_epoch * self.max_epochs

    def _train_step(self, module: TrainModule, batch: dict) -> torch.Tensor:
        """Forward and backward of one batch; the optimizer steps on every
        ``accumulate_grad_batches``-th call, on the mean gradient (over the
        accumulated steps and the processes)."""
        module.zero_grad(set_to_none=True)
        loss = module.training_loss(batch, self.drop_path_generator)
        loss.backward()
        k = self.accumulate_grad_batches
        if k > 1:
            n = self._mini_step
            with torch.no_grad():
                for name, p in module.named_parameters():
                    if p.grad is None:
                        continue
                    if n == 0:
                        self._acc[name] = p.grad
                    else:  # optax: acc + (g - acc) / (n + 1)
                        acc = self._acc[name]
                        acc.add_((p.grad - acc) / (n + 1))
                    p.grad = None
            self._mini_step = (n + 1) % k
            if self._mini_step:
                return loss
            for name, p in module.named_parameters():
                p.grad = self._acc.pop(name, None)
        # the global mean gradient: after accumulation, before clipping
        all_reduce_gradients_(module.parameters())
        if self.gradient_clip_val:
            if self.gradient_clip_algorithm == "value":
                clip_by_value_(module.parameters(), self.gradient_clip_val)
            else:
                clip_by_global_norm_(module.parameters(), self.gradient_clip_val)
        self.optimizer.step()
        self.scheduler.step()
        return loss

    def _profile_start(self) -> None:
        """Start the step trace before step ``profile_steps[0]``."""
        if (self.profile_dir and self.is_rank_zero and self._profiler is None
                and self.global_step == self.profile_steps[0]):
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()

    def _profile_stop(self, fit_end: bool = False) -> None:
        """Stop the trace after step ``profile_steps[1]`` (or at the fit's
        end) and write it to ``profile_dir``."""
        if self._profiler is None or not (fit_end or self.global_step == self.profile_steps[1]):
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
        self._profiler.export_chrome_trace(
            str(Path(self.profile_dir) / f"trace_steps_{self.profile_steps[0]}-{self.global_step}.json")
        )
        self._profiler = None

    # -- fit ----------------------------------------------------------------------
    def fit(self, module: TrainModule, datamodule, ckpt_path: str | Path | None = None) -> None:
        """Train ``module`` on ``datamodule.train_dataloader()`` batches,
        validating and checkpointing at epoch ends; ``ckpt_path`` resumes
        from a checkpoint (the epoch after its epoch, at its step)."""
        self._active_datamodule = datamodule
        prepare = getattr(datamodule, "prepare_data", None)
        if prepare is not None:
            prepare()
        datamodule.setup("fit")
        module.to(self.device).train()
        self._load_pretrained(module)
        broadcast_module_(module)
        if self.optimizer is None:
            total = self._total_steps(datamodule, datamodule.train_dataloader())
            self.optimizer, self.scheduler, self._schedule = module.configure_optimizers(total)
        if ckpt_path is not None:
            self.load_checkpoint(ckpt_path, module)
        transform = getattr(datamodule, "device_transform", None)
        for cb in self.callbacks:
            cb.on_fit_start(self, module)
        self.generator = torch.Generator(device=self.device).manual_seed(self._rank_seed(self.seed + 1))
        self.drop_path_generator = torch.Generator(device=self.device).manual_seed(self._rank_seed(self.seed + 2**32))
        max_epochs = 1 if self.fast_dev_run else self.max_epochs
        for epoch in range(self.current_epoch, max_epochs):
            self.current_epoch = epoch
            module.on_epoch_start(epoch)
            if hasattr(datamodule, "set_epoch"):
                datamodule.set_epoch(epoch)
            for cb in self.callbacks:
                cb.on_train_epoch_start(self, module, epoch)
            step_t0 = epoch_t0 = time.perf_counter()
            feed = BatchPrefetcher(datamodule.train_dataloader(), self.device, self.limit_train_batches)
            for i, batch in enumerate(feed):
                self._profile_start()
                if transform is not None:
                    batch = transform(batch, self.generator, "train")
                loss = self._train_step(module, batch)
                self._profile_stop()
                self.global_step += 1
                metrics = {"loss/train": loss.detach()}
                if self.global_step % self.log_every_n_steps == 0 or self.fast_dev_run:
                    now = time.perf_counter()
                    host = {
                        "loss/train": float(all_reduce_mean(loss.detach())),
                        "lr": float(self._schedule(self.global_step)),
                        "step_time_ms": (now - step_t0) / max(self.log_every_n_steps, 1) * 1e3,
                    }
                    step_t0 = now
                    self.logged_metrics.update(host)
                    self.logger.log_metrics(host, self.global_step)
                for cb in self.callbacks:
                    cb.on_train_batch_end(self, module, metrics, batch, i)
                if self.max_steps and self.global_step >= self.max_steps:
                    break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._log_epoch_feed(epoch, feed, time.perf_counter() - epoch_t0)
            val_metrics = {}
            if (epoch + 1) % self.check_val_every_n_epoch == 0 or self.fast_dev_run:
                val_gen = torch.Generator(device=self.device).manual_seed(self._rank_seed(self.seed + 2 + epoch))
                val_metrics = self._run_validation(module, datamodule, val_gen)
            for cb in self.callbacks:
                cb.on_train_epoch_end(self, module, epoch)
            if (epoch + 1) % self.checkpoint_every_n_epochs == 0 and not self.fast_dev_run:
                self._save_checkpoint(module, val_metrics)
            if self.max_steps and self.global_step >= self.max_steps:
                break
        self._profile_stop(fit_end=True)
        for cb in self.callbacks:
            cb.on_fit_end(self, module)

    @staticmethod
    def _rank_seed(seed: int) -> int:
        return seed + process_index() * RANK_SEED_STRIDE

    def _load_pretrained(self, module: TrainModule) -> None:
        """``module.load_pretrained()``, once per trainer, after the weights
        are built and before the optimizer and any checkpoint load."""
        if not self._pretrained_loaded:
            module.load_pretrained()
            self._pretrained_loaded = True

    def _run_validation(self, module: TrainModule, datamodule, generator: torch.Generator) -> dict:
        """Mean validation metrics: device transforms, then the loss's own
        draws (token masks), drawn from ``generator``."""
        loader_fn = getattr(datamodule, "val_dataloader", None)
        loader = loader_fn() if loader_fn is not None else None
        if loader is None:
            return {}
        transform = getattr(datamodule, "device_transform", None)
        for cb in self.callbacks:
            cb.on_validation_epoch_start(self, module)
        agg: dict[str, list[float]] = {}
        was_training = module.training
        module.eval()
        with torch.no_grad():
            for i, batch in enumerate(BatchPrefetcher(loader, self.device, self.limit_val_batches)):
                if transform is not None:
                    batch = transform(batch, generator, "val")
                host = {"loss/validate": float(module.validation_loss(batch, generator))}
                for k, v in host.items():
                    agg.setdefault(k, []).append(v)
                for cb in self.callbacks:
                    cb.on_validation_batch_end(self, module, host, batch, i)
        module.train(was_training)
        mean_metrics = _mean_over_ranks({k: float(np.mean(v)) for k, v in agg.items()}, self.device)
        if mean_metrics:
            self.logged_metrics.update(mean_metrics)
            self.logger.log_metrics(mean_metrics, self.global_step)
        for cb in self.callbacks:
            cb.on_validation_epoch_end(self, module, mean_metrics)
        return mean_metrics

    def validate(self, module: TrainModule, datamodule, ckpt_path: str | Path | None = None) -> dict:
        """Mean validation metrics of ``module`` over ``val_dataloader()``
        (device transforms and the loss's token masks drawn from a
        generator seeded with 0, plus the rank's seed stride)."""
        self._active_datamodule = datamodule
        prepare = getattr(datamodule, "prepare_data", None)
        if prepare is not None:
            prepare()
        datamodule.setup("validate")
        module.to(self.device)
        self._load_pretrained(module)
        if ckpt_path:
            self.load_checkpoint(ckpt_path, module)
        generator = torch.Generator(device=self.device).manual_seed(self._rank_seed(0))
        return self._run_validation(module, datamodule, generator)

    def test(self, module: TrainModule, datamodule, ckpt_path: str | Path | None = None) -> dict:
        """Mean over ``test_dataloader()``'s batches of every metric of
        ``module.test_step`` (eval mode, no gradient), after loading
        ``ckpt_path`` if given; logged as ``test/<key>`` and printed as a
        table. A key missing from some batches (the segmentation leg's, on
        batches without labels) is the mean over the batches that have it."""
        self._active_datamodule = datamodule
        prepare = getattr(datamodule, "prepare_data", None)
        if prepare is not None:
            prepare()
        datamodule.setup("test")
        module.to(self.device).eval()
        self._load_pretrained(module)
        if ckpt_path:
            self.load_checkpoint(ckpt_path, module)
        agg: dict[str, list[float]] = {}
        with torch.no_grad():
            for i, batch in enumerate(BatchPrefetcher(datamodule.test_dataloader(), self.device)):
                host = {k: float(v) for k, v in module.test_step(batch).items()}
                for k, v in host.items():
                    agg.setdefault(k, []).append(v)
                for cb in self.callbacks:
                    cb.on_test_batch_end(self, module, host, batch, i)
        mean_metrics = _mean_over_ranks({k: float(np.mean(v)) for k, v in agg.items()}, self.device)
        self.logger.log_metrics({f"test/{k}": v for k, v in mean_metrics.items()}, self.global_step)
        if mean_metrics:
            width = max(len(k) for k in mean_metrics)
            lines = "\n".join(f"  test/{k:<{width}}  {v:.6f}" for k, v in sorted(mean_metrics.items()))
            _logger.info(f"Test metrics (mean over {len(next(iter(agg.values())))} batches):\n{lines}")
        else:
            _logger.warning("Test stage saw zero batches — nothing to report")
        for cb in self.callbacks:
            cb.on_test_end(self, module, mean_metrics)
        return mean_metrics

    # -- predict --------------------------------------------------------------------
    def predict(
        self,
        module: TrainModule,
        datamodule,
        ckpt_path: str | Path | None = None,
        return_predictions: bool = False,
    ) -> list[Any] | None:
        """Run ``module.predict_step`` over ``datamodule.predict_dataloader()``
        under ``torch.inference_mode()``, after loading ``ckpt_path`` if given.

        Batches reach the device through the prefetcher (host leaves such as
        a triplet batch's ``index`` list pass as they are), then, on a
        datamodule that sets ``predict_device_transform``, its
        ``device_transform`` at stage ``"predict"``; predictions stay
        where the step put them and go to the callbacks (and the returned
        list) as they are, so a writer that ``wants_device_predictions``
        blends on the device.

        Runs in one process only, as the JAX trainer does: the writers
        assemble whole stores on one host.
        """
        if process_count() > 1:
            raise NotImplementedError(
                "Trainer.predict runs in one process: run one process per output store (shard the work by FOV "
                f"or plate) instead of a {process_count()}-process job"
            )
        self._active_datamodule = datamodule
        prepare = getattr(datamodule, "prepare_data", None)
        if prepare is not None:
            prepare()
        datamodule.setup("predict")
        module.to(self.device).eval()
        self._load_pretrained(module)
        if ckpt_path:
            self.load_checkpoint(ckpt_path, module)
        for cb in self.callbacks:
            cb.on_predict_start(self, module)
        transform = datamodule.device_transform if getattr(datamodule, "predict_device_transform", False) else None
        outputs = []
        with torch.inference_mode():
            for i, batch in enumerate(BatchPrefetcher(datamodule.predict_dataloader(), self.device)):
                if transform is not None:
                    batch = transform(batch, None, "predict")
                pred = module.predict_step(batch)
                for cb in self.callbacks:
                    cb.write_on_batch_end(self, module, pred, batch, i)
                if return_predictions:
                    outputs.append(pred)
        for cb in self.callbacks:
            cb.on_predict_end(self, module)
        return outputs if return_predictions else None

    def _log_epoch_feed(self, epoch: int, feed: BatchPrefetcher, seconds: float) -> None:
        """Record the epoch's steps, wall time and the time the loop waited
        for batches (``feed_stats``), and log them."""
        stats = self.feed_stats
        stats["steps"] += feed.batches
        stats["seconds"] += seconds
        stats["wait_s"] += feed.wait_s
        if feed.batches:
            _logger.info(
                "epoch %d: %d steps in %.2f s (%.3f it/s); waited %.2f s (%.1f%%) for batches",
                epoch, feed.batches, seconds, feed.batches / seconds, feed.wait_s,
                100 * feed.wait_s / max(seconds, 1e-9),
            )

    # -- checkpoints -------------------------------------------------------------------
    def _ckpt_dir(self) -> Path:
        d = self.default_root_dir / "checkpoints"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _save_checkpoint(self, module: TrainModule, val_metrics: dict) -> Path | None:
        """:meth:`_write_checkpoint` on rank 0, between barriers in a job of
        several processes (the others wait and get None). A running mean
        gradient of an unfinished accumulation becomes its mean over the
        processes first, on every rank, so a resume from rank 0's file
        continues the global mean (the update's final mean is unchanged)."""
        self._acc = {name: all_reduce_mean(g) for name, g in self._acc.items()}
        barrier()
        path = self._write_checkpoint(module, val_metrics) if self.is_rank_zero else None
        barrier()
        return path

    def _write_checkpoint(self, module: TrainModule, val_metrics: dict) -> Path:
        """Save a checkpoint laid out as a Lightning one: ``state_dict``
        (``model.<reference name>``, float32 on the CPU), ``optimizer`` and
        ``scheduler`` state dicts, ``step`` and ``epoch``; with accumulation
        also the mini-step and the running mean gradient; the engine's
        :meth:`~TrainModule.checkpoint_state`, where it has one, as
        ``engine_state`` (on the CPU)."""
        score = val_metrics.get(self.checkpoint_monitor)
        name = f"epoch={self.current_epoch}-step={self.global_step}"
        if score is not None:
            name += f"-loss={score:.3f}"
        path = self._ckpt_dir() / name
        payload = {
            "state_dict": {f"model.{k}": v.detach().cpu() for k, v in module.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.global_step,
            "epoch": self.current_epoch,
        }
        if self.accumulate_grad_batches > 1:
            payload["accumulation"] = {"mini_step": self._mini_step, "grads": dict(self._acc)}
        engine_state = module.checkpoint_state() if hasattr(module, "checkpoint_state") else {}
        if engine_state:
            payload["engine_state"] = _to_cpu(engine_state)
        tmp = path.with_name(path.name + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        last = self._ckpt_dir() / "last"
        if last.is_symlink() or last.exists():
            last.unlink()
        last.symlink_to(path.absolute())
        if score is not None:
            # top-k by the monitored value (lower is better); never prune
            # the checkpoint "last" points at
            self._ckpt_scores.append((score, str(path)))
            self._ckpt_scores.sort(key=lambda t: t[0])
            last_target = str(path.absolute())
            keep: list[tuple[float, str]] = []
            while len(self._ckpt_scores) - len(keep) > self.checkpoint_top_k:
                worst_score, worst = self._ckpt_scores.pop()
                if str(Path(worst).absolute()) == last_target:
                    keep.append((worst_score, worst))
                    continue
                Path(worst).unlink(missing_ok=True)
            self._ckpt_scores.extend(keep)
            self._ckpt_scores.sort(key=lambda t: t[0])
        return path

    def load_checkpoint(self, path: str | Path, module: TrainModule) -> None:
        """Load a checkpoint (a port one, a Lightning one, or a bare
        ``state_dict``) into ``module`` and the trainer: the weights always,
        and the engine state (``engine_state``) when the payload has it;
        the optimizer, scheduler and accumulation state when the payload has
        them and they fit this trainer (else a warning and the fresh
        optimizer); the epoch after the saved one and the saved step."""
        payload, state = read_checkpoint(path)
        module.model.load_state_dict(state, strict=True)
        if "engine_state" in payload:
            module.load_checkpoint_state(payload["engine_state"])
        if "optimizer" in payload and self.optimizer is not None:
            accumulating = self.accumulate_grad_batches > 1
            try:
                if accumulating != ("accumulation" in payload):
                    raise ValueError("gradient accumulation differs")
                self.optimizer.load_state_dict(payload["optimizer"])
                self.scheduler.load_state_dict(payload["scheduler"])
            except (ValueError, KeyError) as e:
                _logger.warning(
                    "checkpoint %s: optimizer state does not fit the current trainer (%s); "
                    "restoring weights only (fresh optimizer state)", path, e,
                )
            else:
                if accumulating:
                    acc = payload["accumulation"]
                    self._mini_step = int(acc["mini_step"])
                    self._acc = {k: v.to(self.device) for k, v in acc["grads"].items()}
        # the payload records the finished epoch: resume at the next one
        self.current_epoch = int(payload.get("epoch", -1)) + 1
        self.global_step = int(payload.get("step", 0))


def _to_cpu(node):
    """A nested dict's tensors detached and on the CPU."""
    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    return node.detach().cpu() if isinstance(node, torch.Tensor) else node


def read_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """``(payload, model state_dict)`` of a checkpoint: a port one, a
    Lightning one (``model.``-prefixed names) or a bare ``state_dict``;
    ``last`` is followed to its target."""
    path = Path(path)
    if path.name == "last" and path.is_symlink():
        resolved = path.resolve()
        if not resolved.exists():
            raise FileNotFoundError(
                f"'last' checkpoint symlink {path} points at {resolved}, which no longer "
                "exists (it may have been pruned); pass an epoch=*-step=* checkpoint instead"
            )
        path = resolved
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = payload.get("state_dict", payload)
    if any(k.startswith("model.") for k in state):
        state = {k[len("model."):]: v for k, v in state.items() if k.startswith("model.")}
    return payload, state
