"""Data parallelism across processes (counterpart of ``viscy_tpu/parallel/``'s
``data`` axis and multi-process runtime): :mod:`.distributed` starts the
process group and names the ranks, :mod:`.mesh` holds the collectives the
trainer, the losses and BatchNorm use."""

from viscy_tpu_torch.parallel.distributed import (
    is_rank_zero,
    local_device,
    maybe_initialize,
    process_count,
    process_index,
)
from viscy_tpu_torch.parallel.mesh import (
    all_reduce_gradients_,
    all_reduce_mean,
    barrier,
    broadcast_module_,
    data_parallel,
    gather_batch,
    global_max,
    global_sum,
    local_batch_slice,
)

__all__ = [
    "all_reduce_gradients_",
    "all_reduce_mean",
    "barrier",
    "broadcast_module_",
    "data_parallel",
    "gather_batch",
    "global_max",
    "global_sum",
    "is_rank_zero",
    "local_batch_slice",
    "local_device",
    "maybe_initialize",
    "process_count",
    "process_index",
]
