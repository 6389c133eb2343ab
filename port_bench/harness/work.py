"""The work of the model, counted from the configuration's shapes: the
multiply-adds of every conv, transposed conv and matmul of one forward, and
the least time the card could take for a piece of work.

Peaks of one NVIDIA H100 SXM (the data sheet, dense, at 700 W), and the
bound rule (every input byte read once, every output byte written once; the
larger of bytes over the memory rate and operations over the peak of the
operand type) are those of the program's ``chip_smoke.bound_ms``."""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp16": 989e12, "int8": 1979e12, "fp32": 67e12,
            "tf32": 495e12}
BYTES = {"fp32": 4, "bf16": 2, "fp16": 2, "int8": 1}


def bound_s(ops: float, nbytes: float, kind: str) -> float:
    """The least seconds the card could take for ``ops`` operations of
    operand type ``kind`` that move ``nbytes``."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS[kind])


@dataclass(frozen=True)
class Conv:
    """One conv of the forward: ``macs`` multiply-adds; the input has
    ``in_elems`` elements and the output ``out_elems``; the weight
    ``w_elems``."""
    name: str
    stage: int
    macs: int
    in_elems: int
    out_elems: int
    w_elems: int
    kind: str  # "conv3x3", "head", "tail", "down", "up"


def convs(geom, batch: int, t_size: int) -> list:
    """Every conv of one forward at [batch, channels, t_size, f_size]."""
    out = []
    t, f = t_size, geom.f_size
    cin, c0 = geom.channels, geom.ch[0]
    n = batch * t * f
    out.append(Conv("head", 0, n * 9 * cin * c0, n * cin, n * c0,
                    9 * cin * c0, "head"))
    prev = None
    sizes = []
    for i, (c, r) in enumerate(zip(geom.ch, geom.res)):
        if prev is not None:
            n_in = batch * t * f
            t, f = t // 2, f // 2
            n = batch * t * f
            out.append(Conv(f"down{i}", i, n * 16 * prev * c, n_in * prev,
                            n * c, 16 * prev * c, "down"))
        n = batch * t * f
        sizes.append((t, f))
        for b in range(r):
            for k in (1, 2):
                out.append(Conv(f"s{i}.down.b{b}.conv{k}", i, n * 9 * c * c,
                                n * c, n * c, 9 * c * c, "conv3x3"))
        prev = c
    for i in range(len(geom.ch) - 1, -1, -1):
        c = geom.ch[i]
        t, f = sizes[i]
        n = batch * t * f
        for b in range(geom.res[i]):
            for k in (1, 2):
                out.append(Conv(f"s{i}.up.b{b}.conv{k}", i, n * 9 * c * c,
                                n * c, n * c, 9 * c * c, "conv3x3"))
        if i > 0:
            p = geom.ch[i - 1]
            out.append(Conv(f"up{i}", i, n * 16 * c * p, n * c, n * 4 * p,
                            16 * c * p, "up"))
    n = batch * t_size * geom.f_size
    out.append(Conv("tail", 0, n * 9 * c0 * cin, n * c0, n * cin,
                    9 * c0 * cin, "tail"))
    return out


def matmul_macs(geom, batch: int, t_size: int) -> int:
    """Multiply-adds of the forward's matmuls: the timestep MLP, the FNet's
    projections, DFT mixing and feed-forwards."""
    s = t_size // geom.scale
    h, io, i = geom.fnet_hidden, geom.token_width, geom.fnet_intermediate
    temb = 128 * 512 + 512 * 512 + 512 * sum(geom.widths)
    layer = 2 * (s * s * h + s * h * h) + 2 * s * h * i
    return batch * (temb + 2 * s * io * h + geom.fnet_layers * layer)


def forward_flops(geom, batch: int, t_size: int) -> int:
    """2 × the multiply-adds of one forward."""
    macs = sum(c.macs for c in convs(geom, batch, t_size))
    return 2 * (macs + matmul_macs(geom, batch, t_size))
