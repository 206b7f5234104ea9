"""Data parallelism: decoding over a device mesh in one process
(`mesh.py`), training over one process per device (`distributed.py`)."""

from controllable_xgating_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_parallel_train_step,
    replicate,
    shard_batch,
    shard_rows,
)

__all__ = ["Mesh", "make_mesh", "make_parallel_train_step", "replicate", "shard_batch",
           "shard_rows"]
