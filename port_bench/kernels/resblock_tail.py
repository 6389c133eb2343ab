"""Kernel family resblock_tail: each resblock's tail ``x + GN3(s)`` with the
next block's GroupNorm statistics, one pass of ``residual_affine_kernel``
(the float tail of the sampling forward, and the int8-storage tail).

Work per denoiser step, from the configuration's shapes and declared dtypes
(``declared`` in the configuration file), whatever kernel does it: for each
of the forward's resblocks (each block's conv2 output in
``harness.work.convs``), one read of x and of s and one write of the
output, in the compute dtype. Under int8 storage (widths up to
``act_store_max_width``) s is int8 with one fp32 scale a 8 × 16 group of a
channel, as is x except at a stage's entry, which arrives in the compute
dtype, and as is the output except at a stage's last block, which leaves
in the compute dtype (``kernels/conv3x3.py`` counts storage so). The bound
is bytes only: a few operations an element."""

from __future__ import annotations

import re

from port_bench.harness.work import BYTES, PEAK_BYTES, convs

NAMES = re.compile(r"\bresidual_affine_kernel\b")


def bound_per_step(run) -> float:
    """The least seconds the card could take for the resblock tails of one
    denoiser step."""
    d = run.config["declared"]
    dt = BYTES[d["sample_dtype"]]
    nbytes = 0.0
    for cv in convs(run.geom, run.batch, run.t_size):
        if cv.kind != "conv3x3" or not cv.name.endswith("conv2"):
            continue
        n = cv.out_elems
        c = run.geom.ch[cv.stage]
        if d.get("act_store") == "int8" and c <= d["act_store_max_width"]:
            stored = n + 4 * (n // 128)  # int8 and its group scales
            block = int(cv.name.split(".")[2][1:])
            first, last = block == 0, block == run.geom.res[cv.stage] - 1
            nbytes += ((dt * n if first else stored) + stored
                       + (dt * n if last else stored))
        else:
            nbytes += 3 * dt * n
    return nbytes / PEAK_BYTES
