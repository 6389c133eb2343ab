"""The attention family's share of its roofline over the traced denoiser steps of the SD UNet, in %."""

from port_bench.harness import readers


def read(run):
    return readers.roofline(run, "attention")
