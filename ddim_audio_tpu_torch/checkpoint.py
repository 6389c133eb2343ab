"""Checkpoint / resume (port of ``ddim_audio_tpu/checkpoint.py``): a rolling
``ckpt.npz`` plus step-tagged ``ckpt_<step>.npz`` files holding the whole
TrainState (parameters, every optimizer state, EMA, step) in the JAX
package's format, key for key (``weights.py``), so either package resumes
from the other's file. Loading fills a template of the same structure (made
by initialising model and optimizer again) and validates every leaf. Under a
process group only rank 0 writes: every rank holds the same state."""

from __future__ import annotations

import os

from .parallel.mesh import world_rank
from .weights import (
    flatten_train_state,
    read_checkpoint,
    train_state_from_jax,
    write_checkpoint,
)


def save_checkpoint(log_path: str, state, step: int, *, epoch: int = 0,
                    tag: str | None = None) -> str:
    """Write ``ckpt_<step>.npz`` (or ``ckpt_<tag>.npz``) and the rolling
    ``ckpt.npz``, each through a ``.tmp`` file and ``os.replace``. Returns
    the tagged file's path (on every rank; only rank 0 writes)."""
    path = os.path.join(log_path,
                        f"ckpt_{tag if tag is not None else step}.npz")
    if world_rank() != 0:
        return path
    os.makedirs(log_path, exist_ok=True)
    arrays = flatten_train_state(state)
    for target in (path, os.path.join(log_path, "ckpt.npz")):
        write_checkpoint(target, arrays, step=step, epoch=epoch)
    return path


def load_checkpoint(path: str, template):
    """(state like template, meta): leaves filled from the file by key path;
    a missing, extra or mis-shaped leaf raises."""
    arrays, meta = read_checkpoint(path)
    return train_state_from_jax(arrays, template), meta


def checkpoint_path(log_path: str, ckpt_id=None) -> str:
    """The checkpoint file a run loads: the rolling ``ckpt.npz`` by default,
    the step-tagged ``ckpt_<id>.npz`` when ``sampling.ckpt_id`` is set."""
    if ckpt_id is None:
        return os.path.join(log_path, "ckpt.npz")
    return os.path.join(log_path, f"ckpt_{ckpt_id}.npz")
