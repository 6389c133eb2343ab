"""3 × the forward FLOPs of the optimizer steps over the window's wall time, as a share of the TF32 peak, in %."""

from port_bench.harness import readers


def read(run):
    return readers.mfu(run)
