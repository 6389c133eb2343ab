"""Exponential moving average of the parameters (port of
``ddim_audio_tpu/training/ema.py``): the shadow starts as a copy of the
parameters, each step ``shadow = (1 − mu)·p + mu·shadow``, and the shadow is
the evaluation parameter tree."""

from __future__ import annotations

from ..utils.tree import tree_map


def ema_init(params):
    return tree_map(lambda p: p.detach().clone(), params)


def ema_update(shadow, params, mu: float):
    return tree_map(lambda s, p: (1.0 - mu) * p + mu * s, shadow, params)


def ema_apply(shadow):
    return shadow
