from .distributed import maybe_initialize_distributed
from .mesh import (
    all_reduce_grads, all_reduce_metrics, all_reduce_sum, barrier, broadcast_object,
    check_divisible, gather_rows, global_mean, global_means, local_rows, process_count,
    process_index, read_counts, replicate, reset_counts, shard_batch,
)

__all__ = [
    "all_reduce_grads", "all_reduce_metrics", "all_reduce_sum", "barrier", "broadcast_object",
    "check_divisible", "gather_rows", "global_mean", "global_means", "local_rows",
    "maybe_initialize_distributed", "process_count", "process_index", "read_counts",
    "replicate", "reset_counts", "shard_batch",
]
