"""Summed ms of the train step's ``ddim.train.backward`` spans in each traced optimizer step, averaged over the steps."""

from port_bench.harness import spans


def read(run):
    return spans.ms_per_step(run, "ddim.train.backward")
