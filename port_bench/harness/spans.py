"""The arithmetic of the readers of the program's own spans: the ``ddim.*``
ranges that ``ddim_audio_tpu_torch.utils.tracing.span`` puts in a traced
window (the runner's, the sampler's and the train step's), read from
``run.trace.spans`` and ``run.trace.host``. Each returns None where the trace
has none of the spans it reads, as with a program that lacks them."""

from __future__ import annotations

import bisect
import statistics

# host calls that launch a kernel: the runtime's cudaLaunchKernel (and its
# Ex / ExC forms) and the CUDA driver API's cuLaunchKernel (cuBLAS, cuDNN)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def inside(spans: list, lo: float, hi: float) -> list:
    """The (start, end) of spans that lie within [lo, hi]."""
    return [(a, b) for a, b in spans if lo <= a and b <= hi]


def total_ms(spans: list) -> float:
    return sum(b - a for a, b in spans) / 1e3


def export_ms_per_clip(run):
    """The runner's export ms over the clips it wrote, in the chains the
    benchmark traced."""
    spans = run.trace.spans
    exports = spans.get("ddim.runner.export", [])
    clips = spans.get("ddim.runner.export.clip", [])
    ms, n = 0.0, 0
    for lo, hi in spans.get("bench.chain", []):
        ms += total_ms(inside(exports, lo, hi))
        n += len(inside(clips, lo, hi))
    return ms / n if n else None


def runner_host_ms_per_chain(run):
    """Each chain's span minus its sampler loop and its wait for the card
    and copy (``ddim.runner.to_host``): the runner's own host ms, averaged
    over the traced chains."""
    spans = run.trace.spans
    out = []
    for lo, hi in spans.get("ddim.runner.chain", []):
        waits = [s for name in ("ddim.sampler.loop", "ddim.runner.to_host")
                 for s in inside(spans.get(name, []), lo, hi)]
        if waits:
            out.append((hi - lo) / 1e3 - total_ms(waits))
    return statistics.fmean(out) if out else None


def _steps_with(run, name: str) -> list:
    """[(step, [its spans called name])] over the benchmark's step spans,
    or [] where no step holds such a span."""
    parts = run.trace.spans.get(name, [])
    steps = [(s, inside(parts, *s)) for s in run.trace.spans.get("bench.step",
                                                                  [])]
    return steps if any(p for _, p in steps) else []


def ms_per_step(run, name: str):
    """The summed ms of the spans called name inside each traced step,
    averaged over the steps."""
    steps = _steps_with(run, name)
    return statistics.fmean(total_ms(p) for _, p in steps) if steps else None


def launches_per_step(run, name: str):
    """Host launch calls (``LAUNCH_CALLS``) that start inside the spans
    called name, per traced step."""
    steps = _steps_with(run, name)
    if not steps:
        return None
    starts = [ts for n, ts, _ in run.trace.host if n.startswith(LAUNCH_CALLS)]
    calls = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
                for _, parts in steps for a, b in parts)
    return calls / len(steps)
