"""Data parallelism over ``torch.distributed`` (``mesh.py``)."""

from .mesh import (
    Mesh,
    all_gather_batch,
    barrier,
    batch_mean,
    batch_sharding,
    batch_sum,
    global_batch,
    init_mesh,
    is_primary,
    make_mesh,
    replicated,
    shard_batch,
    sync_batch_norm,
)

__all__ = [
    "Mesh",
    "all_gather_batch",
    "barrier",
    "batch_mean",
    "batch_sharding",
    "batch_sum",
    "global_batch",
    "init_mesh",
    "is_primary",
    "make_mesh",
    "replicated",
    "shard_batch",
    "sync_batch_norm",
]
