"""The training step's update in one multi-tensor pass
(``csrc/train_update.cu``): the gradients' division by the microbatch count,
the global-norm clip, each group's AdaBelief or Adam / AdamW rule, ``p + u``
and the moving average, over every leaf of the parameter tree in four
launches, where the per-leaf route (``training.train_step.update_plain``)
launches about 33 small kernels a leaf. It ports no TPU kernel: XLA fuses
the JAX package's optax update.

The wrapper sees flat lists of leaves, one order for all of them, each
leaf's (group, clip group) tag, and each group's ``Rule`` and step scalars;
the optimizer's trees are the training layer's
(``training.train_step.update_fused``). With the clip not engaged the
result equals the per-leaf route's bit for bit (each element rounded as the
per-leaf ops round it on the card); the norms (the clip's, ``grad_norm``,
``update_norm``) sum in another order, within fp32 rounding.

Outputs are fresh: one flat buffer a state kind (parameters, first moments,
second moments, average), each leaf a view into it. The leaves given are
never written. The tables of the tree's chunks and leaves are made once per
shapes, tags and device (``_LAYOUTS``); the leaves' pointers go in the
launches' parameters each step.

``fits`` says whether a step's tensors can take the kernel: CUDA fp32 leaves
outside ``twin_route``, at most MAX_LEAVES of them, MAX_GROUPS groups and
MAX_CLIPS clip groups. ``train_update.launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ._cuda import check, kernels, stream_ptr, use_twin

_KINDS = {"adabelief": 0, "adam": 1}
_DECAYS = {"": 0, "l2": 1, "decoupled": 2}
# kMaxLeaves, kMaxGroups, kMaxClips of the kernel
MAX_LEAVES, MAX_GROUPS, MAX_CLIPS = 760, 4, 4


@dataclasses.dataclass(frozen=True)
class Rule:
    """One group's elementwise rule: ``kind`` "adabelief" (without amsgrad
    or clip_step) or "adam" (without amsgrad); ``decay`` "" none, "l2"
    (Adam: wd·p into the gradient before the moments) or "decoupled"
    (AdaBelief: −(lr·wd)·p after the step; AdamW: wd·p before the learning
    rate)."""

    kind: str
    decay: str
    b1: float
    b2: float
    eps: float
    weight_decay: float


class _Rule(ctypes.Structure):
    """``Rule`` of ``csrc/train_update.cu``."""
    _fields_ = [("kind", ctypes.c_int), ("decay", ctypes.c_int),
                ("b1", ctypes.c_float), ("omb1", ctypes.c_float),
                ("b2", ctypes.c_float), ("omb2", ctypes.c_float),
                ("eps", ctypes.c_float), ("wd", ctypes.c_float),
                ("dev", ctypes.c_void_p * 4), ("host", ctypes.c_float * 4)]


class _Config(ctypes.Structure):
    """``Config`` of ``csrc/train_update.cu``."""
    _fields_ = [("n_groups", ctypes.c_int), ("n_clips", ctypes.c_int),
                ("divide", ctypes.c_int), ("has_ema", ctypes.c_int),
                ("inv_count", ctypes.c_float), ("ema_keep", ctypes.c_float),
                ("ema_rate", ctypes.c_float), ("pad", ctypes.c_float),
                ("clip_on", ctypes.c_int * MAX_CLIPS),
                ("clip_max", ctypes.c_float * MAX_CLIPS),
                ("rules", _Rule * MAX_GROUPS)]


@functools.lru_cache(maxsize=None)
def chunk_size(lib) -> int:
    """The kernel library's elements a chunk, after checking that its
    limits and its Config are this module's."""
    out = (ctypes.c_int * 5)()
    lib.ddim_train_update_limits(ctypes.addressof(out))
    max_leaves, chunk, groups, clips, config_size = list(out)
    if (max_leaves, groups, clips, config_size) != (
            MAX_LEAVES, MAX_GROUPS, MAX_CLIPS, ctypes.sizeof(_Config)):
        raise RuntimeError("train_update: the kernel's limits or Config "
                           "differ from ops/train_update.py's")
    return chunk


class Layout:
    """The leaves' places in the flat outputs (each leaf's start rounded up
    to 4 elements, so that a chunk moves 16 bytes a thread), the chunk table
    (one row a block: leaf, start, length, start in the flat outputs; a
    chunk is ``chunk`` elements or a leaf's rest) and the leaf table (group,
    clip group, first chunk, end chunk)."""

    def __init__(self, shapes, tags, device, chunk: int):
        self.spans, chunks, meta, off = [], [], [], 0
        for i, (shape, (group, clip)) in enumerate(zip(shapes, tags)):
            n = math.prod(shape)
            stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
            self.spans.append((shape, stride, off))
            first = len(chunks)
            chunks += [(i, s, min(chunk, n - s), off + s)
                       for s in range(0, n, chunk)]
            meta.append((group, clip, first, len(chunks)))
            off += -(-n // 4) * 4
        if off >= 2 ** 31:
            raise ValueError("train_update: the tree has 2^31 elements or "
                             "more (int32 offsets)")
        self.total, self.n_chunks = off, len(chunks)
        self.chunks = torch.tensor(chunks, dtype=torch.int32,
                                   device=device).view(-1, 4)
        self.meta = torch.tensor(meta, dtype=torch.int32, device=device)

    def views(self, flat):
        """The leaves of a flat buffer, in the given order."""
        return [flat.as_strided(*span) for span in self.spans]


_LAYOUTS = {}


def _layout(leaves, tags, lib) -> Layout:
    device = leaves[0].device
    key = (device, tuple(t.shape for t in leaves), tags)
    lay = _LAYOUTS.get(key)
    if lay is None:
        lay = _LAYOUTS[key] = Layout([tuple(s) for s in key[1]], tags, device,
                                     chunk_size(lib))
    return lay


def fits(grads, params, ema, n_groups: int, n_clips: int) -> bool:
    """Whether a step can take the kernel: its gradients, parameters and
    average (or None), lists of leaves, CUDA fp32 tensors outside
    ``twin_route``; a tree of at most MAX_LEAVES leaves; at most MAX_GROUPS
    groups and MAX_CLIPS clip groups."""
    if not grads or len(grads) > MAX_LEAVES or use_twin(grads[0]):
        return False
    if n_groups > MAX_GROUPS or n_clips > MAX_CLIPS:
        return False
    return all(t.is_cuda and t.dtype == torch.float32
               for t in (*grads, *params, *(ema or ())))


def _f32(x) -> float:
    """A Python number rounded to fp32 as torch rounds a scalar operand."""
    return float(np.float32(x))


def _rule_struct(rule: Rule, values) -> _Rule:
    r = _Rule(kind=_KINDS[rule.kind], decay=_DECAYS[rule.decay],
              b1=_f32(rule.b1), omb1=_f32(1.0 - rule.b1), b2=_f32(rule.b2),
              omb2=_f32(1.0 - rule.b2), eps=_f32(rule.eps),
              wd=_f32(rule.weight_decay))
    for j, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            if v.dtype != torch.float32 or v.numel() != 1:
                raise TypeError("train_update: a step scalar must be a 0-d "
                                f"fp32 tensor, got {v.dtype} {tuple(v.shape)}")
            r.dev[j] = v.data_ptr()
        else:
            r.host[j] = _f32(v)
    return r


def _pointers(*columns) -> np.ndarray:
    """[len(columns) · n] uint64: each column's tensors' addresses (0 for
    None), column after column."""
    return np.array([0 if t is None else t.data_ptr()
                     for col in columns for t in col], dtype=np.uint64)


def train_update(grads, params, firsts, seconds, ema, *, tags, rules,
                 scalars, clips, ema_rate: float, count: int):
    """One optimizer step in the kernel. ``grads``, ``params``, ``firsts``,
    ``seconds`` and ``ema`` (or None: no average) are lists of leaves in one
    order: the gradient sums over ``count`` microbatches (and ranks), the
    parameters, each leaf's first and second moments, the average. ``tags``:
    each leaf's (group, clip group), a tuple of pairs of indices into
    ``rules`` and ``clips``. ``rules``: each group's ``Rule``; ``scalars``:
    each group's (−lr, lr·wd, bc1, bc2) of this step, each a 0-d fp32 tensor
    on the leaves' device or a Python number. ``clips``: each clip group's
    max norm, or None for no clip. Returns (params, firsts, seconds, ema,
    grad_norm, update_norms): new leaves in the same order, never the given
    ones written; grad_norm the norm of the gradients over ``count`` before
    the clip; update_norms [len(rules)], each AdaBelief group's mean of its
    leaves' update norms (the other entries unset). Take it where ``fits``
    holds."""
    lib = kernels()
    lay = _layout(params, tags, lib)
    device = params[0].device
    stream = stream_ptr(params[0])
    n = len(params)
    grads = [g.contiguous() for g in grads]

    cfg = _Config(n_groups=len(rules), n_clips=len(clips),
                  divide=int(count > 1), has_ema=int(ema is not None),
                  inv_count=_f32(np.float32(1.0) / np.float32(count)),
                  ema_keep=_f32(1.0 - ema_rate), ema_rate=_f32(ema_rate))
    for k, max_norm in enumerate(clips):
        cfg.clip_on[k] = int(max_norm is not None)
        cfg.clip_max[k] = _f32(max_norm or 0.0)
    for k, (rule, values) in enumerate(zip(rules, scalars)):
        cfg.rules[k] = _rule_struct(rule, values)

    def flat():
        return torch.empty(lay.total, dtype=torch.float32, device=device)

    p_out, m_out, v_out = flat(), flat(), flat()
    e_out = flat() if ema is not None else None
    # the chunks' sums of g² and of u², the leaves' update norms, the clip
    # groups' norms and all, the groups' means
    sizes = [lay.n_chunks, lay.n_chunks, n, len(clips) + 1, MAX_GROUPS]
    norm_parts, partials, leaf_norms, norms, update_norms = torch.empty(
        sum(sizes), dtype=torch.float32, device=device).split(sizes)
    cfg_p = ctypes.addressof(cfg)

    def data(t):
        return None if t is None else t.data_ptr()

    # the step scalars (``scalars``) and the pointer table stay referenced
    # until the launches are queued; the norm reads its first column
    table = _pointers(grads, params, firsts, seconds,
                      ema if ema is not None else [None] * n)
    with torch.cuda.device(device):
        check(lib.ddim_train_update_norm(
            table.ctypes.data, n, data(lay.chunks), lay.n_chunks, cfg_p,
            data(norm_parts), stream), "train_update norm")
        check(lib.ddim_train_update_norm_finish(
            data(norm_parts), data(lay.chunks), data(lay.meta), lay.n_chunks,
            cfg_p, data(norms), stream), "train_update norm_finish")
        check(lib.ddim_train_update_apply(
            table.ctypes.data, n, data(lay.chunks), lay.n_chunks,
            data(lay.meta), cfg_p, data(p_out), data(m_out), data(v_out),
            data(e_out), data(norms), data(partials), stream),
            "train_update apply")
        check(lib.ddim_train_update_finish(
            data(partials), data(lay.meta), n, cfg_p, data(leaf_norms),
            data(update_norms), stream), "train_update finish")
    train_update.launches += 4

    return (lay.views(p_out), lay.views(m_out), lay.views(v_out),
            lay.views(e_out) if ema is not None else None, norms[len(clips)],
            update_norms)


train_update.launches = 0
