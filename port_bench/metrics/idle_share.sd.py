"""Share of the traced SD chain in which the device is idle (1 − the union of its operations' intervals over the window), in %."""

from port_bench.harness import readers


def read(run):
    return readers.idle_share(run)
