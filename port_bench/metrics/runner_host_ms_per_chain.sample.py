"""The runner's own host ms a chain: ``ddim.runner.chain`` minus its ``ddim.sampler.loop`` and ``ddim.runner.to_host`` (weights, finalize, filter, export), averaged over the traced chains."""

from port_bench.harness import spans


def read(run):
    return spans.runner_host_ms_per_chain(run)
