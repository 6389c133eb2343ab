"""Host kernel-launch calls that start inside the train step's ``ddim.train.update`` spans (clip, optimizers, ``apply_updates``, EMA), per traced optimizer step."""

from port_bench.harness import spans


def read(run):
    return spans.launches_per_step(run, "ddim.train.update")
