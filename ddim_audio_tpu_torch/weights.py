"""The weight bridge from the JAX package (load side of
``ddim_audio_tpu/checkpoint.py``).

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


def load_jax_checkpoint(path: str, which: str = "ema", device="cuda"):
    """Read a ``ddim_audio_tpu`` checkpoint (``ckpt*.npz``, keys are JAX tree
    paths such as ``.ema['down_modules']['stages'][0]['blocks'][1]['conv1']['w']``)
    and return (params, meta) for the ``which`` subtree ("ema" or "params"),
    as the JAX runner's ``_load_eval_params`` picks the EMA weights for
    evaluation."""
    device = resolve_device(device)
    if which not in ("ema", "params"):
        raise ValueError(f"which must be 'ema' or 'params', got {which!r}")
    prefix = f".{which}["
    tree = {}
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        for key in data.files:
            if key.startswith(prefix):
                _insert(tree, _parse_path(key[len(which) + 1:]), data[key])
    if not tree:
        raise KeyError(f"{path} holds no '{which}' parameters")
    return params_from_jax(tree, device), meta


def _flatten(tree, prefix: str, out: dict) -> dict:
    """Leaves keyed by their JAX tree path (``['a'][0]['w']``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}['{k}']", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}[{i}]", out)
    else:
        out[prefix] = tree.detach().float().cpu().numpy()
    return out


def save_eval_checkpoint(log_path: str, params, *, which: str = "ema",
                         step: int = 0) -> str:
    """Write ``<log_path>/ckpt.npz`` holding ``params`` as the ``which``
    subtree, in the key and meta format of the JAX package's
    ``checkpoint.save_checkpoint`` (what ``load_jax_checkpoint`` and the
    sampling CLI read). Evaluation weights only: no optimizer state."""
    if which not in ("ema", "params"):
        raise ValueError(f"which must be 'ema' or 'params', got {which!r}")
    os.makedirs(log_path, exist_ok=True)
    arrays = _flatten(params, f".{which}", {})
    meta = {"step": int(step), "epoch": 0, "num_leaves": len(arrays),
            "format": 1}
    path = os.path.join(log_path, "ckpt.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)
    return path
