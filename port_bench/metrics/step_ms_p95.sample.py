"""95th percentile of the device ms between the starts of consecutive denoiser steps (head conv kernels)."""

from port_bench.harness import readers


def read(run):
    return readers.step_ms_p95(run)
