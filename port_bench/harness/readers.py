"""The arithmetic the per-layer metric readers share. A reader returns None
where its run has nothing for it to read; the harness then leaves the
metric out of the line."""

from __future__ import annotations

import statistics


def steps(run):
    """The steps traced, or None where the window ran nothing on the
    device."""
    if not run.trace.kernels():
        return None
    return run.facts.get("steps_traced") or None


def launches_per_step(run):
    n = steps(run)
    return None if not n else len(run.trace.kernels()) / n


def device_ms_per_step(run):
    n = steps(run)
    return None if not n else run.trace.busy_us() / 1e3 / n


def idle_share(run):
    """The share of the traced window in which no device operation runs:
    1 − the union of the device intervals over the window's length."""
    if not steps(run):
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / run.trace.window_us)


def mfu(run):
    """Model FLOPs of the untraced window's steps over its wall time, as a
    share of the configuration's peak for this mode."""
    wall = run.facts.get("wall_timed_s")
    if not wall:
        return None
    peak = run.config["mfu_peak_tflops"][run.mode] * 1e12
    return 100.0 * run.facts["flops_timed"] / wall / peak


def roofline(run, family: str):
    """The family's least time for the traced steps over the device time
    of its kernels in the window, in %."""
    fam = run.registry.kernel_family(family)
    n = steps(run)
    dev_us = sum(d for _, _, d in run.trace.kernels(pattern=fam.NAMES))
    if not n or dev_us <= 0:
        return None
    return 100.0 * fam.bound_per_step(run) * n / (dev_us / 1e6)


def step_ms_p95(run):
    """The 95th percentile of the intervals between the starts of
    consecutive step markers (one kernel a step) inside each chain span."""
    marker = run.facts.get("step_marker")
    gaps = []
    for lo, hi in run.trace.spans.get("bench.chain", []):
        starts = [ts for _, ts, _ in run.trace.kernels(lo, hi, marker)]
        gaps += [(b - a) / 1e3 for a, b in zip(starts, starts[1:])]
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=20, method="inclusive")[-1]


def runner_ms_per_chain(run):
    """Each chain span's host time outside the denoiser: the span minus the
    device interval from its first step marker's start to its last end
    marker's end, averaged over the traced chains."""
    start_marker = run.facts.get("step_marker")
    end_marker = run.facts.get("end_marker")
    out = []
    for lo, hi in run.trace.spans.get("bench.chain", []):
        first = run.trace.kernels(lo, hi, start_marker)
        last = run.trace.kernels(lo, hi, end_marker)
        if not first or not last:
            continue
        denoise = last[-1][1] + last[-1][2] - first[0][1]
        out.append((hi - lo - denoise) / 1e3)
    return statistics.fmean(out) if out else None
