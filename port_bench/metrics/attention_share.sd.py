"""The attention family's device time (``kernels/attention.py``) over the
traced chain's busy device time (the union of its device operations'
intervals), in %; nothing where no attention kernel ran."""

from port_bench.harness import readers


def read(run):
    if not readers.steps(run):
        return None
    fam = run.registry.kernel_family("attention")
    attn_us = sum(d for _, _, d in run.trace.kernels(pattern=fam.NAMES))
    busy_us = run.trace.busy_us()
    if attn_us <= 0 or busy_us <= 0:
        return None
    return 100.0 * attn_us / busy_us
