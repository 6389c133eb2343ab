"""The resblock_tail family's share of its roofline over the traced denoiser steps, in %."""

from port_bench.harness import readers


def read(run):
    return readers.roofline(run, "resblock_tail")
