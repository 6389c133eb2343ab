"""Device kernels in the traced window per optimizer step."""

from port_bench.harness import readers


def read(run):
    return readers.launches_per_step(run)
