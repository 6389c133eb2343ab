"""The work the benchmark counts: the model's FLOPs against torch's own
counter on the reference forward, and the bound arithmetic against the
program's kernel table."""

from __future__ import annotations

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.harness.params import make_params
from port_bench.harness.registry import Registry
from port_bench.harness.work import (BYTES, bound_s, convs, forward_flops)
from port_bench.reference.model import Geometry, Model, param_spec
from port_bench.tests import tiny


@pytest.mark.parametrize("batch,t_size", [(1, 16), (3, 32)])
def test_flops_match_torch_counter(batch, t_size):
    geom = Geometry.from_config(tiny.tiny_config())
    params = make_params(param_spec(geom), 11, "cpu")
    x = torch.randn(batch, geom.channels, t_size, geom.f_size)
    t = torch.tensor([3] * batch)
    with FlopCounterMode(display=False) as counter:
        Model(geom, "cpu")(params, x, t)
    assert counter.get_total_flops() == forward_flops(geom, batch, t_size)


def test_audio_yml_counts():
    conf = Registry().config("ddim-audio")["config"]
    geom = Geometry.from_config(conf)
    cv = convs(geom, 1, 8192)
    res = [c for c in cv if c.kind == "conv3x3"]
    assert len(res) == 64
    by_stage = sum(4 * r * (8192 * 256 // 4 ** i) * 9 * c * c
                   for i, (c, r) in enumerate(zip(geom.ch, geom.res)))
    assert sum(c.macs for c in res) == by_stage == 544_789_757_952
    assert forward_flops(geom, 2, 8192) == 2 * forward_flops(geom, 1, 8192)


def test_conv3x3_bound_reproduces_the_kernel_table():
    # the program's kernel table, row 1, s0 in bf16 at B = 1: x, residual
    # and output [1, 8192, 256·32] and the 3×3 weight, 0.120 ms
    elems = 8192 * 256 * 32
    nbytes = BYTES["bf16"] * (3 * elems + 9 * 32 * 32)
    ms = 1e3 * bound_s(2 * 9 * 32 * elems, nbytes, "bf16")
    assert round(ms, 3) == 0.120


@pytest.mark.parametrize("cell", ["sample-ddim100-b8", "train-b14"])
def test_conv3x3_family_bound(cell):
    reg = Registry()
    w = reg.cell(cell)
    conf, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
    run = types.SimpleNamespace(
        config=conf, traffic=traffic, mode=traffic["driver"],
        geom=Geometry.from_config(conf["config"]),
        batch=traffic.get("num_samples", traffic.get("batch")),
        t_size=traffic["t_size"])
    bound = reg.kernel_family("conv3x3").bound_per_step(run)
    # every resblock conv moves at least its input and output once
    floor = sum(c.in_elems + c.out_elems for c in
                convs(run.geom, run.batch, run.t_size)
                if c.kind == "conv3x3") / 3.35e12
    assert floor <= bound < 4 * BYTES["fp32"] * floor
