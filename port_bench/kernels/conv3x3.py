"""Kernel family conv3x3: the 3×3 convs of the resblocks (and, in
training, of the head and tail, which the training forward runs as square
3×3 convs) and their gradients.

Work per step, from the configuration's shapes and declared dtypes
(``declared`` in the configuration file), whatever kernel does it:

- sampling, per denoiser step: the resblock convs of one forward. Float
  taps read and write the compute dtype; int8 taps (widths up to
  ``int8_taps_max_width``) multiply int8 operands and move the compute
  dtype; int8 storage (widths up to ``act_store_max_width``) reads int8
  and its scales (one fp32 a 8 × 16 group of a channel) except at a stage's
  entry, which arrives in the compute dtype, and writes int8 and scales;
  its taps are float.
- training, per optimizer step: forward, input gradient and weight
  gradient of each resblock conv and of the tail, forward and weight
  gradient of the head, in fp32 at the tensor cores' TF32 rate. A
  recomputed forward (remat) is time, not work.
"""

from __future__ import annotations

import re

from port_bench.harness.work import BYTES, bound_s, convs

NAMES = re.compile(r"\bconv3x3_(?:mma_|int8_|store_mma_|store_fma_|tf32_)?"
                   r"kernel\b|\bconv_dw\w*_kernel<(?:\w+, )?0>")


def _sample_bound(run) -> float:
    d = run.config["declared"]
    dt = BYTES[d["sample_dtype"]]
    total = 0.0
    entry = True  # conv1 of a stage's first block
    for cv in convs(run.geom, run.batch, run.t_size):
        if cv.kind != "conv3x3":
            entry = True
            continue
        c = run.geom.ch[cv.stage]
        ops = 2 * cv.macs
        if d.get("act_store") == "int8" and c <= d["act_store_max_width"]:
            scales = 4 * (cv.in_elems // 128)
            read = (dt * cv.in_elems if entry and cv.name.endswith("conv1")
                    else cv.in_elems + scales)
            nbytes = read + dt * cv.w_elems + cv.out_elems + scales
            total += bound_s(ops, nbytes, d["sample_dtype"])
        elif d.get("tap_int8") and c <= d["int8_taps_max_width"]:
            nbytes = dt * (cv.in_elems + cv.out_elems) + cv.w_elems
            total += bound_s(ops, nbytes, "int8")
        else:
            nbytes = dt * (cv.in_elems + cv.out_elems + cv.w_elems)
            total += bound_s(ops, nbytes, d["sample_dtype"])
        entry = False
    return total


def _train_bound(run) -> float:
    b = BYTES["fp32"]
    total = 0.0
    for cv in convs(run.geom, run.batch, run.t_size):
        if cv.kind not in ("conv3x3", "head", "tail"):
            continue
        ops = 2 * cv.macs
        x, y, w = cv.in_elems, cv.out_elems, cv.w_elems
        total += bound_s(ops, b * (x + w + y), "tf32")      # forward
        total += bound_s(ops, b * (x + y + w), "tf32")      # weight grad
        if cv.kind != "head":                                # input grad
            total += bound_s(ops, b * (y + w + x), "tf32")
    return total


def bound_per_step(run) -> float:
    """The least seconds the card could take for this family's work of one
    denoiser step (sampling) or one optimizer step (training)."""
    return _train_bound(run) if run.mode == "train" else _sample_bound(run)
