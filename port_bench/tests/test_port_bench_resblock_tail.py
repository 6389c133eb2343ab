"""The resblock_tail kernel family: its bound at the sampling cell (x and s
read and the output written once in bf16 for each of the forward's 32
resblocks) and the roofline reader on hand-made traces, which reads nothing
where no ``residual_affine_kernel`` ran (the torch passes of an older
program) and the bound over the kernels' time where they did."""

from __future__ import annotations

import types

import pytest

from port_bench.harness import readers
from port_bench.harness.registry import Registry
from port_bench.harness.trace import Trace
from port_bench.harness.work import PEAK_BYTES, convs
from port_bench.reference.model import Geometry

CELL = "sample-ddim100-b8"


def _run(events=(), **declared):
    reg = Registry()
    w = reg.cell(CELL)
    conf, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
    conf["declared"].update(declared)
    window = {"name": "bench.window", "cat": "user_annotation", "ph": "X",
              "ts": 0, "dur": 1e6}
    return types.SimpleNamespace(
        registry=reg, config=conf, traffic=traffic, mode=traffic["driver"],
        geom=Geometry.from_config(conf["config"]),
        batch=traffic["num_samples"], t_size=traffic["t_size"],
        trace=Trace([window, *events]), facts={"steps_traced": 2})


def _kernel(name, ts, dur):
    return {"name": name, "cat": "kernel", "ph": "X", "ts": ts, "dur": dur}


def test_bound_is_six_bytes_an_element_of_the_32_tails():
    run = _run()
    tails = [c for c in convs(run.geom, run.batch, run.t_size)
             if c.kind == "conv3x3" and c.name.endswith("conv2")]
    assert len(tails) == 32
    elems = sum(c.out_elems for c in tails)
    assert elems == 4_127_195_136
    bound = run.registry.kernel_family("resblock_tail").bound_per_step(run)
    assert bound == pytest.approx(6 * elems / PEAK_BYTES)
    assert round(bound * 1e3, 2) == 7.39
    # int8 storage moves int8 and its scales between a stage's blocks
    store = _run(act_store="int8")
    assert 0.5 * bound < store.registry.kernel_family(
        "resblock_tail").bound_per_step(store) < bound


def test_roofline_reads_the_tail_kernels_alone():
    fam_bound = _run().registry.kernel_family("resblock_tail") \
        .bound_per_step(_run())
    conv = _kernel("void ddim::conv3x3_mma_kernel<1>(...)", 10, 500)
    assert readers.roofline(_run([conv]), "resblock_tail") is None
    tail = "void ddim::residual_affine_kernel<1, 1, false, true>(...)"
    dev_us = 4 * fam_bound * 1e6  # two steps at half the bound's rate
    run = _run([conv, _kernel(tail, 600, dev_us / 2),
                _kernel(tail, 600 + dev_us, dev_us / 2)])
    assert readers.roofline(run, "resblock_tail") == pytest.approx(50.0)
