"""Union of the device operations' intervals per guided denoiser step of the SD UNet, in ms."""

from port_bench.harness import readers


def read(run):
    return readers.device_ms_per_step(run)
