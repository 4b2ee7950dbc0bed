from .mesh import DataParallelGroup, data_parallel_group, default_backend, \
    default_world, launch, rank_device, replicate, shard_batch

__all__ = ["DataParallelGroup", "data_parallel_group", "default_backend",
           "default_world", "launch", "rank_device", "replicate",
           "shard_batch"]
