"""Data-parallel collectives (counterpart of ``viscy_tpu/parallel/mesh.py``'s
``data`` axis).

The JAX step is one program over the global batch, sharded over a
``data`` mesh axis. Here each process runs its own rows, and these
functions give back what the global program computes: global sums and
the global batch with their gradients, mean gradients, rank 0's weights.
There is no mesh object: the process group is the data axis. A batch
statistic outside the model, such as MS-SSIM's data range (the target's
maximum over the batch), is global too (:func:`global_max`).

Every collective is an ``all_reduce`` or a ``broadcast``, the two that
gloo carries for CUDA tensors too, so one code path runs over gloo on the
CPU, over gloo with several processes on one card, and over NCCL across
cards. Every function is the identity when no process group is up;
:func:`global_sum` and :func:`gather_batch` are also the identity in a
group of one process, so a one-process job computes bit for bit what a
run without a group computes.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from viscy_tpu_torch.parallel import distributed
from viscy_tpu_torch.parallel.distributed import process_count

# elements per flattened bucket of the gradient reduce and the broadcast
BUCKET_ELEMS = 1 << 24


def data_parallel() -> bool:
    """True when more than one process shares the batch."""
    return process_count() > 1


def local_batch_slice(global_index_count: int, process_index: int | None = None) -> slice:
    """This process's contiguous slice of a global index space; the last
    process takes the remainder."""
    p = distributed.process_index() if process_index is None else process_index
    n = process_count()
    per = global_index_count // n
    return slice(p * per, (p + 1) * per if p < n - 1 else global_index_count)


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the processes (a new tensor; no gradient)."""
    if not dist.is_initialized():
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out.div_(process_count())


class _GlobalSum(torch.autograd.Function):
    """``all_reduce`` (sum) forward and backward: the autograd rule of
    ``torch.distributed.nn.functional.all_reduce``, which torch 2.13
    deprecates."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _GlobalSum.apply(grad)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes, differentiable: the backward
    sums the incoming gradients over the processes, so a loss computed on
    every rank from global sums, with the ranks' gradients then averaged,
    gives the gradient of that one loss."""
    if not data_parallel():
        return x
    return _GlobalSum.apply(x)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The largest of a 0-d ``x`` over the processes, without gradient: each
    rank writes its value into its slot of a zero vector, the slots are
    summed and the largest is taken."""
    if not data_parallel():
        return x
    slots = x.new_zeros(process_count())
    slots[distributed.process_index()] = x.detach()
    dist.all_reduce(slots)
    return slots.max()


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch along dim 0 (rank 0's rows first), differentiable.

    Each rank writes its rows into its slot of a zero tensor of the global
    size and the slots are summed (:func:`global_sum`); the backward hands
    each rank its slot of the summed gradient. Ranks may hold different
    row counts (they are exchanged first)."""
    if not data_parallel():
        return x
    world, rank = process_count(), distributed.process_index()
    sizes = torch.zeros(world, dtype=torch.int64, device=x.device)
    sizes[rank] = x.shape[0]
    dist.all_reduce(sizes)
    sizes = sizes.tolist()
    before, after = sum(sizes[:rank]), sum(sizes[rank + 1 :])
    pad = lambda n: x.new_zeros((n, *x.shape[1:]))
    return global_sum(torch.cat([pad(before), x, pad(after)]))


def _buckets(tensors: list[torch.Tensor]) -> Iterable[list[torch.Tensor]]:
    """``tensors`` in their order, grouped by dtype and device into runs of
    at most :data:`BUCKET_ELEMS` elements (a larger tensor goes alone)."""
    bucket: list[torch.Tensor] = []
    elems = 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or elems + t.numel() > BUCKET_ELEMS):
            yield bucket
            bucket, elems = [], 0
        bucket.append(t)
        elems += t.numel()
    if bucket:
        yield bucket


def all_reduce_gradients_(parameters: Iterable[torch.nn.Parameter]) -> None:
    """Replace every trainable parameter's gradient by its mean over the
    processes, in flattened buckets, in the parameters' order. A missing
    gradient counts as zeros, so the ranks always agree on each reduce's
    shape; a parameter that has a gradient on no rank keeps ``None``."""
    if not dist.is_initialized():
        return
    params = [p for p in parameters if p.requires_grad]
    if not params:
        return
    world = process_count()
    had = torch.tensor([p.grad is not None for p in params], dtype=torch.float32, device=params[0].device)
    dist.all_reduce(had)
    for bucket in _buckets(params):
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in bucket])
        dist.all_reduce(flat)
        flat.div_(world)
        for p, chunk in zip(bucket, flat.split([p.numel() for p in bucket])):
            if p.grad is not None:
                p.grad.copy_(chunk.view_as(p.grad))
            else:
                p.grad = chunk.view_as(p).clone()
    for p, h in zip(params, had.tolist()):
        if not h:
            p.grad = None


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite every parameter and buffer of ``module`` with rank ``src``'s,
    in flattened buckets."""
    if not dist.is_initialized():
        return
    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.broadcast(flat, src=src)
        for t, chunk in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(chunk.view_as(t))


def barrier() -> None:
    """Wait for every process (a no-op without a process group)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
