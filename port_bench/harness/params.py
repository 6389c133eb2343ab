"""Seed-made parameters and inputs, on the device, in the tree the program
takes (``reference.model.param_spec``): one uniform draw and one normal
draw for the whole tree, then a scale per leaf."""

from __future__ import annotations

import math

import numpy as np
import torch


def seed_for(seed: int, *stream: int) -> int:
    """A generator seed for one stream of draws of a run's seed (any whole
    number, larger than 32 bits too)."""
    words = [int(seed) % (1 << 64), *[int(s) % (1 << 32) for s in stream]]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) >> 1


def generator(device, seed: int, *stream: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed_for(seed, *stream))


def _specs(spec, out):
    if isinstance(spec, dict):
        for k in sorted(spec):
            _specs(spec[k], out)
    elif isinstance(spec, list):
        for v in spec:
            _specs(v, out)
    else:
        out.append(spec)
    return out


def make_params(spec, seed: int, device) -> dict:
    """The tree of ``spec`` with float32 leaves drawn from ``seed``: uniform
    leaves in ±bound, norm gains 1 + spread·N(0, 1), norm biases
    spread·N(0, 1)."""
    leaves = _specs(spec, [])
    n_uni = sum(math.prod(s[1]) for s in leaves if s[0] == "uniform")
    n_nrm = sum(math.prod(s[1]) for s in leaves if s[0] != "uniform")
    gen = generator(device, seed, 1)
    uni = torch.rand(n_uni, generator=gen, device=device).mul_(2).sub_(1)
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    pos = {"uniform": 0, "norm": 0}

    def take(s):
        kind, shape, scale = s
        pool = "uniform" if kind == "uniform" else "norm"
        src = uni if pool == "uniform" else nrm
        n = math.prod(shape)
        v = src[pos[pool]:pos[pool] + n].view(shape)
        pos[pool] += n
        v.mul_(scale)
        if kind == "norm_gain":
            v.add_(1.0)
        return v.clone()  # a block of its own: the kernels want aligned rows

    def build(sp):
        if isinstance(sp, dict):
            return {k: build(sp[k]) for k in sorted(sp)}
        if isinstance(sp, list):
            return [build(v) for v in sp]
        return take(sp)

    tree = build(spec)
    del uni, nrm
    return tree


# The head's share of the default init, and GN3's gains (times 1 + 0.2·N),
# of the weights a DDIM walk runs on. With the defaults ε carries the head's
# linear map of x through the stage-0 skips (ε ≈ tail(head(x)) + …), so the
# walk feeds ε back into x and the state grows by 1e3-1e6 in a few spots of
# a clip; at these scales ε stays near unit size whatever x is, and the
# state near a Gaussian's shape (its hottest 0.1% of values carry a few
# percent of its square, not most of it).
SAMPLING_HEAD_SCALE = 0.01
SAMPLING_GN3_SCALE = 0.25


def sampling_params(spec, seed: int, device) -> dict:
    """``make_params`` of the same seed with the head and GN3's gains scaled
    as above: the weights of the sampling cells."""
    tree = make_params(spec, seed, device)
    head = tree["down_modules"]["head"]
    head["w"].mul_(SAMPLING_HEAD_SCALE)
    head["b"].mul_(SAMPLING_HEAD_SCALE)

    def gn3(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == "norm3":
                    v["g"].mul_(SAMPLING_GN3_SCALE)
                else:
                    gn3(v)
        elif isinstance(t, list):
            for v in t:
                gn3(v)

    gn3(tree)
    return tree
