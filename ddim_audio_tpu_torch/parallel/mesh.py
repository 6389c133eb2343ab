"""The dp × sp mesh over the ranks of the default process group (port of
``ddim_audio_tpu/parallel/mesh.py``).

One process drives one device. The JAX package lays a ``Mesh`` of devices
out as dp × sp; here the ranks of ``torch.distributed``'s default group are
laid out the same way, rank = d·sp + s, and each rank holds a process group
of its sp row (the ranks that split one clip's time axis) and of its dp
column (the ranks that split the batch):

- **dp**: batch sharding. Sampling runs each rank's slice of the batch;
  training averages the ranks' gradients with one all-reduce.
- **sp**: time-axis sharding of long clips (``parallel/sp.py``: halo
  exchanges around the convs, GroupNorm sums all-reduced, the bottleneck's
  tokens gathered).

Parameters are identical on every rank (each rank builds or loads the same
tree). Every collective here is one that both NCCL and gloo run on device
tensors (all-reduce, all-gather, broadcast), so the same code runs across
cards under NCCL and with several ranks on one card under gloo.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the dp × sp layout and its two groups."""

    dp: int
    sp: int
    rank: int
    dp_group: object = None  # the ranks of this rank's dp column
    sp_group: object = None  # the ranks of this rank's sp row

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp


def _axes(parallel_cfg) -> tuple[int, int]:
    if not parallel_cfg:
        return 1, 1
    return (int(getattr(parallel_cfg, "dp", 1) or 1),
            int(getattr(parallel_cfg, "sp", 1) or 1))


def world_size() -> int:
    """Ranks of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(parallel_cfg=None):
    """Mesh from config.parallel {dp, sp}; None when 1 × 1 (one device).
    dp·sp must equal the ranks of the default group: more raises, as the
    JAX package's mesh raises with too few devices (a plain process is one
    rank), and fewer raises too, since a rank outside the mesh would have
    nothing to run. Every rank calls this, in the same order: the groups
    are made collectively."""
    dp, sp = _axes(parallel_cfg)
    if dp * sp <= 1:
        return None
    n = world_size()
    if dp * sp > n:
        raise ValueError(f"mesh dp×sp = {dp}×{sp} needs {dp * sp} devices, "
                         f"have {n}")
    if dp * sp < n:
        raise ValueError(f"mesh dp×sp = {dp}×{sp} covers {dp * sp} of the "
                         f"{n} ranks: launch exactly dp·sp ranks")
    rank = world_rank()
    dp_group = sp_group = None
    for d in range(dp):
        row = [d * sp + s for s in range(sp)]
        g = dist.new_group(row)
        if rank in row:
            sp_group = g
    for s in range(sp):
        col = [d * sp + s for d in range(dp)]
        g = dist.new_group(col)
        if rank in col:
            dp_group = g
    return Mesh(dp=dp, sp=sp, rank=rank, dp_group=dp_group, sp_group=sp_group)


def batch_sharded(mesh, batch: int) -> bool:
    """Whether a batch of this size is split over dp (it must divide)."""
    return mesh is not None and mesh.dp > 1 and batch % mesh.dp == 0


def time_sharded(mesh, length: int) -> bool:
    """Whether a time axis of this length is split over sp."""
    return mesh is not None and mesh.sp > 1 and length % mesh.sp == 0


def shard_batch(mesh, x, *, time_axis=None):
    """This rank's block of a global x: its slice of the leading (batch)
    axis over dp and, with ``time_axis``, of that axis over sp. An axis that
    does not divide evenly stays whole (every rank computes it)."""
    if mesh is None:
        return x
    if batch_sharded(mesh, x.shape[0]):
        per = x.shape[0] // mesh.dp
        x = x[mesh.dp_index * per:(mesh.dp_index + 1) * per]
    if time_axis is not None and time_sharded(mesh, x.shape[time_axis]):
        per = x.shape[time_axis] // mesh.sp
        x = x.narrow(time_axis, mesh.sp_index * per, per)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks of a group concatenated along dim, in rank order."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def gather_batch(mesh, x, global_shape, *, time_axis=None):
    """The inverse of ``shard_batch``: the global tensor of global_shape from
    every rank's block, on every rank."""
    if mesh is None:
        return x
    if time_axis is not None and time_sharded(mesh, global_shape[time_axis]):
        x = all_gather_cat(x, mesh.sp_group, time_axis)
    if batch_sharded(mesh, global_shape[0]):
        x = all_gather_cat(x, mesh.dp_group, 0)
    return x


def shard_params(mesh, params):
    """Parameters are identical on every rank: each rank builds or loads the
    same tree, so there is nothing to move."""
    return params
