"""The device trace of a traced window: ``torch.profiler`` over the CPU and
the card, exported as a Chrome trace into ``TMPDIR`` and read back.

Device operations are the trace's kernels, copies and fills; their union
is the device's busy time. An idle gap is an interval of the window in
which no device operation runs; it is labelled with the innermost host
event (a torch operator, a CUDA runtime call or one of the benchmark's own
spans) that covers its middle."""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


class Trace:
    """Events of one traced window (times in µs of the trace's clock)."""

    def __init__(self, events: list):
        self.device = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e["cat"])
             for e in events if e.get("cat") in DEVICE_CATS
             and e.get("ph") == "X"), key=lambda d: d[1])
        self.host = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
             for e in events if e.get("cat") in HOST_CATS
             and e.get("ph") == "X"), key=lambda h: h[1])
        self.spans = {}
        for e in events:
            if e.get("cat") == "user_annotation" and e.get("ph") == "X":
                self.spans.setdefault(e["name"], []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for v in self.spans.values():
            v.sort()
        if WINDOW not in self.spans:
            raise ValueError(f"the trace has no {WINDOW} span")
        self.window = self.spans[WINDOW][0]

    def kernels(self, lo=None, hi=None, pattern=None):
        """[(name, start, dur)] of the kernels that start in [lo, hi)."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return [(n, ts, d) for n, ts, d, cat in self.device
                if cat == "kernel" and lo <= ts < hi
                and (pattern is None or pattern.search(n))]

    def busy_intervals(self, lo=None, hi=None) -> list:
        """The union of the device operations' intervals, clipped to
        [lo, hi] (the window by default)."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        merged = []
        for _, ts, dur, _ in self.device:
            a, b = max(ts, lo), min(ts + dur, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_us(self, lo=None, hi=None) -> float:
        return sum(b - a for a, b in self.busy_intervals(lo, hi))

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def gaps(self) -> list:
        """[(start, length)] of the window's idle intervals."""
        out, cur = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > cur:
                out.append((cur, a - cur))
            cur = max(cur, b)
        if self.window[1] > cur:
            out.append((cur, self.window[1] - cur))
        return out

    def host_labels(self, points) -> list:
        """For each time of ``points``, the innermost host event that covers
        it (the shortest; of equal ones the last to start), else "host: no
        traced event". One sweep: the points in order, the host events
        pushed onto a heap by length as they start; an event that ended
        before a point ended before every later point too, so it leaves the
        heap for good."""
        out = [None] * len(points)
        heap, i = [], 0
        for k in sorted(range(len(points)), key=points.__getitem__):
            ts = points[k]
            while i < len(self.host) and self.host[i][1] <= ts:
                name, start, dur = self.host[i]
                heapq.heappush(heap, (dur, -i, start + dur, name))
                i += 1
            while heap and heap[0][2] < ts:
                heapq.heappop(heap)
            out[k] = heap[0][3] if heap else "host: no traced event"
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each with its seconds."""
        by_name = {}
        lo, hi = self.window
        for name, ts, dur, _ in self.device:
            if lo <= ts < hi:
                by_name[name] = by_name.get(name, 0.0) + dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:top]
        labels = self.host_labels([ts + d / 2 for ts, d in gaps])
        return {
            "device_ops": [[n[:160], v / 1e6] for n, v in ops],
            "idle_gaps": [[label[:160], d / 1e6]
                          for label, (_, d) in zip(labels, gaps)],
        }


@contextlib.contextmanager
def traced(out: dict, device):
    """Profile the block on the CPU and the card; on exit ``out["trace"]``
    holds its ``Trace``. The block marks its window with a ``WINDOW``
    span (``span``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = Trace(events)


def span(name: str):
    """A host span in the trace (a no-op when no profiler runs)."""
    return torch.profiler.record_function(name)
