"""Device kernels in the traced chain per guided denoiser step of the SD UNet."""

from port_bench.harness import readers


def read(run):
    return readers.launches_per_step(run)
