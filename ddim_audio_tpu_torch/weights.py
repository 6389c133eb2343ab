"""The state bridge to and from the JAX package: the checkpoint format of
``ddim_audio_tpu/checkpoint.py``, key for key, for the whole TrainState
(parameters, every optimizer state, EMA, step), so either package resumes
from the other's file.

A checkpoint is one ``.npz`` whose keys are JAX tree paths:
``.params[…]``, ``.ema[…]``, ``.step``, and for each optimizer group
``.opt_state[1].inner_states['<group>'].inner_state`` followed by
``.<field>`` (AdaBelief: ``count``, ``mu[…]``, ``s[…]``, ``s_max[…]``,
``update_norm``) or ``[i].<field>`` for link i of a chain (Adam-type:
``[0].count``, ``[0].mu[…]``, ``[0].nu[…]``, and the schedule's own
``count`` in the last link); a group's moments hold only its own top-level
subtrees. ``__meta__`` is a JSON string (step, epoch, num_leaves, format).

The port stores parameters in the JAX package's structure and conventions,
so carrying weights across converts containers and arrays, not layouts:

- conv weights stay HWIO [kh, kw, in, out] (torch's Conv2d wants OIHW; the
  plain layers permute at apply time and the CUDA kernels read HWIO);
- transposed-conv weights stay the flipped *equivalent forward* kernel
  (``ddim_audio_tpu/models/layers.py``); ``ops.conv_strided.up_weight_to_torch``
  maps them to torch's ConvTranspose2d [in, out, kh, kw];
- linear weights stay [in, out] (torch's Linear wants [out, in]).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.tree import tree_paths

_TOKEN = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def params_from_jax(tree, device="cuda"):
    """Nested dicts / lists / tuples of numpy (or array-like) leaves, as
    ``ddim_audio_tpu.models.unet.init_model`` returns them, → the same tree
    of fp32 torch tensors on device."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind != "f":
        raise TypeError(f"parameter leaf of dtype {arr.dtype} is not float")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def _insert(tree, tokens, value):
    """Place value at the key path tokens (str → dict key, int → list index)."""
    node = tree
    for tok, nxt in zip(tokens[:-1], tokens[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(tok, int):
            while len(node) <= tok:
                node.append(None)
            if node[tok] is None:
                node[tok] = empty
            node = node[tok]
        else:
            node = node.setdefault(tok, empty)
    last = tokens[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
    node[last] = value


def _parse_path(rest: str):
    tokens, pos = [], 0
    while pos < len(rest):
        m = _TOKEN.match(rest, pos)
        if m is None:
            raise ValueError(f"unparsable checkpoint key path {rest!r}")
        tokens.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    return tokens


def read_checkpoint(path: str):
    """(arrays {key: numpy array}, meta dict) of a checkpoint file."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return arrays, meta


def write_checkpoint(path: str, arrays: dict, *, step: int,
                     epoch: int = 0) -> None:
    """Write arrays + meta to path through ``path.tmp`` and ``os.replace``,
    so a reader never sees a half-written file."""
    meta = {"step": int(step), "epoch": int(epoch),
            "num_leaves": len(arrays), "format": 1}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


_OPT = ".opt_state[1].inner_states"


def _opt_state_paths(opt_state) -> dict:
    out = {}
    for group in sorted(opt_state):
        inner = opt_state[group]
        links = ([("", inner)] if isinstance(inner, dict)
                 else [(f"[{i}]", link) for i, link in enumerate(inner)])
        for idx, link in links:
            for field, value in link.items():
                out.update(tree_paths(
                    value, f"{_OPT}['{group}'].inner_state{idx}.{field}"))
    return out


def train_state_paths(state) -> dict:
    """{checkpoint key: tensor} of a TrainState, the JAX package's keys."""
    out = tree_paths(state.params, ".params")
    out.update(_opt_state_paths(state.opt_state))
    if state.ema is not None:
        out.update(tree_paths(state.ema, ".ema"))
    out[".step"] = state.step
    return out


def flatten_train_state(state) -> dict:
    """{checkpoint key: numpy array} of a TrainState."""
    return {k: v.detach().cpu().numpy()
            for k, v in train_state_paths(state).items()}


def train_state_from_jax(arrays: dict, template):
    """A TrainState with the structure, devices and dtypes of ``template``
    (from ``training.train_step.init_train_state``), its leaves filled from
    ``arrays``: {JAX tree path: array}, as ``read_checkpoint`` returns them
    or as the JAX package's ``checkpoint._flatten(state)`` does for a live
    TrainState. A missing, extra or mis-shaped leaf raises."""
    want = train_state_paths(template)
    extra = set(arrays) - set(want)
    if extra:
        raise ValueError(f"checkpoint has unexpected leaves: "
                         f"{sorted(extra)[:5]}")
    filled = {}
    for key, leaf in want.items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.asarray(arrays[key])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != "
                             f"template {tuple(leaf.shape)}")
        filled[key] = torch.from_numpy(np.array(arr)).to(
            device=leaf.device, dtype=leaf.dtype)

    def fill(tree, prefix):
        return _map_paths(tree, prefix, filled)

    opt_state = {}
    for group, inner in template.opt_state.items():
        base = f"{_OPT}['{group}'].inner_state"
        if isinstance(inner, dict):
            opt_state[group] = {f: fill(v, f"{base}.{f}")
                                for f, v in inner.items()}
        else:
            opt_state[group] = [{f: fill(v, f"{base}[{i}].{f}")
                                 for f, v in link.items()}
                                for i, link in enumerate(inner)]
    return type(template)(
        params=fill(template.params, ".params"), opt_state=opt_state,
        ema=None if template.ema is None else fill(template.ema, ".ema"),
        step=filled[".step"])


def _map_paths(tree, prefix: str, leaves: dict):
    """tree with every leaf replaced by leaves[its key path]."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, f"{prefix}['{k}']", leaves)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_paths(v, f"{prefix}[{i}]", leaves)
                for i, v in enumerate(tree)]
    return leaves[prefix]


def load_jax_checkpoint(path: str, which: str = "ema", device="cuda"):
    """Read a checkpoint (``ckpt*.npz``, written by either package) and
    return (params, meta) for the ``which`` subtree ("ema" or "params"), as
    the runner's ``_load_eval_params`` picks the EMA weights for
    evaluation. Needs no template: the tree is rebuilt from the key paths."""
    device = resolve_device(device)
    if which not in ("ema", "params"):
        raise ValueError(f"which must be 'ema' or 'params', got {which!r}")
    prefix = f".{which}["
    tree = {}
    arrays, meta = read_checkpoint(path)
    for key, value in arrays.items():
        if key.startswith(prefix):
            _insert(tree, _parse_path(key[len(which) + 1:]), value)
    if not tree:
        raise KeyError(f"{path} holds no '{which}' parameters")
    return params_from_jax(tree, device), meta


def save_eval_checkpoint(log_path: str, params, *, which: str = "ema",
                         step: int = 0) -> str:
    """Write ``<log_path>/ckpt.npz`` holding ``params`` as the ``which``
    subtree only (what ``load_jax_checkpoint`` and the sampling CLI read):
    evaluation weights, no optimizer state."""
    if which not in ("ema", "params"):
        raise ValueError(f"which must be 'ema' or 'params', got {which!r}")
    os.makedirs(log_path, exist_ok=True)
    arrays = {k: v.detach().float().cpu().numpy()
              for k, v in tree_paths(params, f".{which}").items()}
    path = os.path.join(log_path, "ckpt.npz")
    write_checkpoint(path, arrays, step=step)
    return path
