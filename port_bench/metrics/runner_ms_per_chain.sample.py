"""Host ms of a chain outside the denoiser's device interval (the runner's noise, weight preparation, finalize, filter, copy and export)."""

from port_bench.harness import readers


def read(run):
    return readers.runner_ms_per_chain(run)
