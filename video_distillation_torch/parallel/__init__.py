"""Multi-device data parallelism (``torch.distributed``); see ``dist``."""

from .dist import (STATS, active, all_reduce_, all_reduce_tensors_,
                   broadcast_tensors_, check_mesh_shape, init_distributed,
                   is_coordinator, local_rank, owns_group,
                   pad_and_split_plan, rank, reduce_scatter, reduced,
                   reset_stats, share, split_columns, split_divisible,
                   world_size)

__all__ = ["STATS", "active", "all_reduce_", "all_reduce_tensors_",
           "broadcast_tensors_", "check_mesh_shape", "init_distributed",
           "is_coordinator", "local_rank", "owns_group",
           "pad_and_split_plan", "rank", "reduce_scatter", "reduced",
           "reset_stats", "share", "split_columns", "split_divisible",
           "world_size"]
