"""The program's export ms per clip written (``ddim.runner.export`` over its ``ddim.runner.export.clip`` spans) in the traced chains."""

from port_bench.harness import spans


def read(run):
    return spans.export_ms_per_clip(run)
