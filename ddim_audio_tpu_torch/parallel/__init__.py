"""Data and sequence parallelism over ``torch.distributed`` ranks."""

from .mesh import Mesh, make_mesh, shard_batch, shard_params

__all__ = ["Mesh", "make_mesh", "shard_batch", "shard_params"]
