"""Gloo ranks on the CPU for the port's parallel tests.

``run_ranks(worker, world, tmp_path, *args)`` starts ``world`` processes
(``torch.multiprocessing.spawn``), joins them into one gloo group through a
``file://`` rendezvous under ``tmp_path`` (no port to pick, so pytest-xdist
workers never collide) and calls ``worker(rank, world, out_dir, *args)`` in
each. A rank's results are what it pickles into ``out_dir`` with ``save``;
``run_ranks`` returns them as a list by rank. The workers live in modules
that import no JAX, so a rank starts in a few seconds. A collective that
waits longer than ``TIMEOUT`` fails its rank, and ranks still running after
``TIMEOUT`` are killed and fail the call.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = 180  # seconds


def save(out_dir: str, rank: int, value) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(value, fh)


def _entry(rank, world, init, out_dir, worker, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        worker(rank, world, out_dir, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(worker, world: int, tmp_path, *args) -> list:
    out_dir = os.path.join(str(tmp_path), f"ranks{world}")
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "rendezvous")
    ctx = mp.spawn(_entry, args=(world, init, out_dir, worker, args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(timeout=5):  # raises when a rank failed
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{world} ranks still running after "
                               f"{TIMEOUT} s")
    out = []
    for rank in range(world):
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        with open(path, "rb") as fh:
            out.append(pickle.load(fh) if os.path.getsize(path) else None)
    return out
