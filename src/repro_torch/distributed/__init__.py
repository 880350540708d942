"""Sharding helpers of the port (the counterpart of ``repro.distributed``).

``shard_map_compat`` has no counterpart: the port's sharded code runs in
one process and places each shard on its device itself."""
from .sharding import (
    NO_SHARD,
    DuplicateSpecError,
    NamedSharding,
    ShardedTensor,
    Sharder,
    batch_partition_axes,
)

__all__ = ["NO_SHARD", "DuplicateSpecError", "NamedSharding", "ShardedTensor", "Sharder",
           "batch_partition_axes"]
