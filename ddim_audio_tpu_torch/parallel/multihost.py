"""Multi-process set-up (port of ``ddim_audio_tpu/parallel/multihost.py``).

One process drives one device. A launcher (``torchrun`` or ``python -m
torch.distributed.run``) starts the processes and sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
``initialize`` joins them into the default process group, after which
``parallel/mesh.py`` lays the ranks out as dp × sp. NCCL joins ranks on
different cards; gloo joins CPU ranks, or several ranks on one card (NCCL
refuses two ranks on one device).

Each rank's input pipeline feeds its own slice of the global batch:
``host_batch_slice`` says which, and ``global_array_from_host_shards``
gathers the slices back into the global batch.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import all_gather_cat, world_rank, world_size

__all__ = ["launched", "initialize", "finalize", "host_batch_slice",
           "global_array_from_host_shards", "world_rank", "world_size"]


def launched() -> bool:
    """Whether a launcher started this process as one of several ranks."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def initialize(init_method: str | None = None, world_size_: int | None = None,
               rank: int | None = None, *, backend: str | None = None,
               device=None) -> torch.device:
    """Join this process into the default process group and return the
    device it drives: ``device`` when the caller names one, else
    ``cuda:LOCAL_RANK``. A CUDA device without a GPU raises before the
    process joins anything; the CPU runs only when the caller names it. The
    backend is NCCL for a CUDA device and gloo for the CPU unless
    ``backend`` says otherwise. Without arguments the group is the
    launcher's (``env://``); ``init_method``, ``world_size_`` and ``rank``
    describe it explicitly."""
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, world_size=world_size_,
                      rank=rank)
    dist.init_process_group(backend, **kwargs)
    logging.info("distributed: rank %d/%d on %s (%s)", world_rank(),
                 world_size(), device, backend)
    return device


def finalize() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_batch_slice(global_batch: int) -> slice:
    """This rank's contiguous slice of the global batch."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} "
                         "ranks")
    per = global_batch // n
    i = world_rank()
    return slice(i * per, (i + 1) * per)


def global_array_from_host_shards(mesh, host_data, global_batch: int, *,
                                  device=None):
    """The global batch from every rank's ``host_batch_slice`` of it: an
    all-gather over the ranks (``mesh`` is kept for the JAX package's
    signature; the slices follow the ranks, not the mesh). ``device``: where
    the shard goes first (the rank's device under NCCL)."""
    x = torch.as_tensor(host_data, device=device)
    group = dist.group.WORLD if dist.is_initialized() else None
    out = all_gather_cat(x, group, 0)
    if out.shape[0] != global_batch:
        raise ValueError(f"the ranks' shards make a batch of {out.shape[0]}, "
                         f"not {global_batch}")
    return out
