"""Multi-process runtime (counterpart of ``viscy_tpu/parallel/distributed.py``).

:func:`maybe_initialize` starts the ``torch.distributed`` process group
when the environment says this process is one of a multi-process job; the
``viscy-torch`` CLI calls it before any device use, so the process count is
right by the time the datamodules build their loaders and the trainer
reduces gradients. :func:`is_rank_zero` gates the checkpoint, log and
metric writes.

Environment contract (checked in order):

1. ``VISCY_COORDINATOR`` (``host:port``, or a ``file://`` URL whose file
   every process can reach) + ``VISCY_NUM_PROCESSES`` +
   ``VISCY_PROCESS_ID``: the JAX package's explicit bootstrap.
2. torchrun's ``RANK`` + ``WORLD_SIZE`` + ``MASTER_ADDR`` + ``MASTER_PORT``.
3. Otherwise: one process, nothing is started.

``LOCAL_RANK`` (default: the process id) names the card of this process:
``torch.cuda.set_device(LOCAL_RANK)`` runs before the group starts, so
every later ``"cuda"`` allocation lands on it. The backend is NCCL for a
CUDA device and gloo for ``device="cpu"`` unless the caller names one; a
failing NCCL start raises and never falls back to gloo. The group is
destroyed at interpreter exit.
"""

from __future__ import annotations

import atexit
import logging
import os
from typing import Mapping

import torch
import torch.distributed as dist

_logger = logging.getLogger("viscy_tpu_torch")


def _contract(env: Mapping[str, str]) -> tuple[str, int, int, int] | None:
    """``(init_method, world, rank, local_rank)`` from the environment, or
    None for a single-process run."""
    coordinator = env.get("VISCY_COORDINATOR")
    if coordinator:
        world, rank = int(env["VISCY_NUM_PROCESSES"]), int(env["VISCY_PROCESS_ID"])
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init = f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    else:
        return None
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is outside a world of {world}")
    return init, world, rank, int(env.get("LOCAL_RANK", rank))


def maybe_initialize(env: Mapping[str, str] | None = None, backend: str | None = None,
                     device: str | torch.device = "cuda") -> bool:
    """Start the process group if the environment calls for it.

    Idempotent; returns True when this process is (or already was) one of
    a job of more than one process. ``device`` is where the job computes:
    ``"cuda"`` binds the process to ``cuda:LOCAL_RANK`` and picks NCCL,
    ``"cpu"`` picks gloo; ``backend`` overrides the pick (gloo for several
    processes on one card: gloo reduces and broadcasts CUDA tensors).
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    spec = _contract(os.environ if env is None else env)
    if spec is None:
        return False
    init, world, rank, local = spec
    cuda = torch.device(device).type == "cuda"
    if cuda:
        count = torch.cuda.device_count()
        if not 0 <= local < count:
            raise RuntimeError(f"LOCAL_RANK {local} names no card: {count} CUDA device(s) visible")
        torch.cuda.set_device(local)
    backend = backend or ("nccl" if cuda else "gloo")
    kwargs = {"device_id": torch.device("cuda", local)} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **kwargs)
    atexit.register(_destroy)
    _logger.info("torch.distributed (%s) initialized: process %d/%d via %s", backend, rank, world, init)
    return world > 1


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """The number of processes of the job (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank_zero() -> bool:
    """True on the process that owns checkpoint, log and metric writes."""
    return process_index() == 0


def local_device() -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK`` once :func:`maybe_initialize`
    has bound it, else the current CUDA device."""
    return torch.device("cuda", torch.cuda.current_device())
