"""Model FLOPs of the denoiser steps over the window's wall time, as a share of the bf16 peak, in %."""

from port_bench.harness import readers


def read(run):
    return readers.mfu(run)
