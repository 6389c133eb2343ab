"""Model FLOPs of the SD UNet's guided steps (convs, matmuls and attention, both rows of the doubled batch) over the window's wall time, as a share of the bf16 peak, in %."""

from port_bench.harness import readers


def read(run):
    return readers.mfu(run)
