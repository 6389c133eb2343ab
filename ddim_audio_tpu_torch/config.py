"""Config loading (port of ``ddim_audio_tpu/config.py``).

The same YAML files (``configs/*.yml``) load into nested namespaces. Dtype
names resolve to torch dtypes; the reference's torch tensor-type spellings
(``configs/audio.yml`` of the original repo) are accepted too.
"""

from __future__ import annotations

import dataclasses

import torch
import yaml

from .utils.namespace import dict2namespace

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "torch.cuda.FloatTensor": torch.float32,
    "torch.FloatTensor": torch.float32,
    "torch.float": torch.float32,
    None: torch.float32,
}


def resolve_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name in _DTYPES:
        return _DTYPES[name]
    raise ValueError(f"unknown dtype name {name!r}")


# Options of the JAX package that this port does not have yet; each names the
# ROADMAP item that ports it. Asking for one raises instead of silently
# running another numeric path.
_NOT_PORTED = {
    "strided_int8": "int8 taps of the strided convs (ROADMAP.md, queue B, "
                    "item B6)",
    "act_store": "int8 activation storage and residual_affine_flat "
                 "(ROADMAP.md, queue B, item B10)",
}


def reject_unported(section, where: str) -> None:
    """Raise NotImplementedError if a config section enables an option the
    port does not implement yet."""
    for key, item in _NOT_PORTED.items():
        value = getattr(section, key, None)
        if value in (None, False, "", "null"):
            continue
        raise NotImplementedError(
            f"{where}.{key}={value!r} is not ported to the PyTorch package "
            f"yet: {item}. Set it to false/null to run the float path.")


def production_eval_cfg(config, model_cfg):
    """The inference-only overrides of ``config.sampling`` applied to a
    ModelConfig (port of ``ddim_audio_tpu/config.py::production_eval_cfg``):
    ``sampling.dtype`` sets the denoiser's compute dtype (the sampler's
    update arithmetic stays fp32) and ``sampling.tap_int8`` switches the
    int8 conv taps on. ``strided_int8`` and ``act_store`` raise
    NotImplementedError (not ported yet)."""
    reject_unported(config.sampling, "sampling")
    cfg = model_cfg
    sdtype = getattr(config.sampling, "dtype", None)
    if sdtype:
        cfg = dataclasses.replace(cfg, dtype=resolve_dtype(sdtype))
    if bool(getattr(config.sampling, "tap_int8", False)):
        cfg = dataclasses.replace(cfg, tap_int8=True)
    return cfg


def load_config(path: str):
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return dict2namespace(raw)
