"""Host launch calls (``harness.spans.LAUNCH_CALLS``) that start inside the
program's ``ddim.sd.transformer`` spans, per ``ddim.sampler.step`` span of
the traced chain; nothing where the trace has none of these spans."""

import bisect

from port_bench.harness import readers, spans


def read(run):
    steps = run.trace.spans.get("ddim.sampler.step", [])
    blocks = run.trace.spans.get("ddim.sd.transformer", [])
    if not readers.steps(run) or not steps or not blocks:
        return None
    starts = [ts for n, ts, _ in run.trace.host
              if n.startswith(spans.LAUNCH_CALLS)]
    calls = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
                for lo, hi in steps for a, b in spans.inside(blocks, lo, hi))
    return calls / len(steps)
