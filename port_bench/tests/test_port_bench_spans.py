"""The readers of the program's ``ddim.*`` spans (``harness/spans.py`` and
their six metric files) on hand-made traces: the export per clip, the
runner's host ms without its child spans, the train step's parts per step,
the launch calls inside the update spans only, and None where the spans are
absent, as in a program without them. Then the tiny cells, traced on the
CPU, report the six metrics."""

from __future__ import annotations

import pytest

from port_bench.harness.cell import execute
from port_bench.harness.registry import Registry
from port_bench.harness.trace import Trace
from port_bench.tests import tiny


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _sample_events(program=True):
    """One traced chain of 2 clips (times in µs)."""
    ev = [_x("bench.window", 0, 10_000), _x("bench.chain", 0, 10_000),
          _x("runner.export", 7_000, 2_900)]
    if program:
        ev += [_x("ddim.runner.chain", 100, 9_800),
               _x("ddim.runner.prepare", 200, 300),
               _x("ddim.sampler.loop", 500, 5_500),
               _x("ddim.runner.finalize", 6_000, 100),
               _x("ddim.runner.filter", 6_100, 400),
               _x("ddim.runner.to_host", 6_500, 500),
               _x("ddim.runner.export", 7_000, 2_800)]
        for k in range(2):
            t0 = 7_050 + 1_350 * k
            ev += [_x("ddim.runner.export.clip", t0, 1_300),
                   _x("ddim.runner.export.png", t0, 800),
                   _x("ddim.runner.export.wav", t0 + 800, 500)]
    return ev


def _train_events(program=True):
    """Two traced steps of one microbatch; host launch calls in every part,
    and other runtime calls beside them."""
    ev = [_x("bench.window", 0, 20_000)]
    for k in range(2):
        t0 = 10_000 * k
        ev.append(_x("bench.step", t0, 9_000))
        parts = (("forward", 100, 2_000), ("backward", 2_100, 4_000),
                 ("update", 6_100, 2_500))
        for part, start, dur in parts:
            if program:
                ev.append(_x(f"ddim.train.{part}", t0 + start, dur))
            for i in range(3 + k):  # 3 launches a part in step 0, 4 in 1
                ts = t0 + start + 10 + 100 * i
                ev += [_x("cudaLaunchKernel" if i % 2 else "cuLaunchKernel",
                          ts, 5, "cuda_runtime"),
                       _x("cudaMemcpyAsync", ts + 6, 2, "cuda_runtime")]
        ev.append(_x("cudaLaunchKernelExC", t0 + 8_000, 5, "cuda_runtime"))
        ev.append(_x("cudaLaunchKernel", t0 + 8_700, 5, "cuda_runtime"))
        if program:
            ev.append(_x("ddim.train.step", t0 + 50, 8_900))
    return ev


class _Run:
    def __init__(self, events):
        self.trace = Trace(events)


SAMPLE = {"export_ms_per_clip.sample": 2.8 / 2,
          "runner_host_ms_per_chain.sample": 9.8 - 5.5 - 0.5}
TRAIN = {"forward_ms_per_step.train": 2.0,
         "backward_ms_per_step.train": 4.0,
         "update_ms_per_step.train": 2.5,
         # (3 + 1) in step 0's update and (4 + 1) in step 1's, over 2 steps
         "update_launches_per_step.train": 4.5}


@pytest.mark.parametrize("name", list(SAMPLE) + list(TRAIN))
def test_readers_on_hand_made_traces(name):
    events = _sample_events() if name in SAMPLE else _train_events()
    got = Registry().metric(name).read(_Run(events))
    assert got == pytest.approx({**SAMPLE, **TRAIN}[name], rel=1e-12)


@pytest.mark.parametrize("name", list(SAMPLE) + list(TRAIN))
def test_readers_return_none_without_the_spans(name):
    events = (_sample_events(program=False) if name in SAMPLE
              else _train_events(program=False))
    assert Registry().metric(name).read(_Run(events)) is None


@pytest.mark.parametrize("cell,names", [("tiny-sample", list(SAMPLE)),
                                        ("tiny-train", list(TRAIN))])
def test_traced_tiny_cells_report_the_span_metrics(tmp_path, cell, names):
    result, _ = execute(tiny.make(tmp_path), cell, 2 ** 33 + 7, 0.01, True,
                        device="cpu")
    for name in names:
        value = result["metrics"][name]["value"]
        assert value >= 0 if name.startswith("update_launches") else value > 0


def _gap_trace(n_short: int):
    """A window of 1 s with kernels at its start and at 0.8 s; a span
    ``outer`` over 10 µs-0.9 s, and ``n_short`` host calls of 1 µs that
    start after it and end before the first gap's middle."""
    ev = [_x("bench.window", 0, 1_000_000), _x("outer", 10, 899_990),
          _x("k0", 0, 100, "kernel"), _x("k1", 800_000, 100, "kernel")]
    ev += [_x("cudaLaunchKernel", 20 + 10 * i, 1, "cuda_runtime")
           for i in range(n_short)]
    return Trace(ev)


def test_gaps_are_labelled_past_any_look_back():
    trace = _gap_trace(5_000)
    gaps = trace.breakdown()["idle_gaps"]
    # the gap in the middle lies inside `outer`, which began 5,001 host
    # events before it; the last one inside the window alone
    assert gaps == [["outer", pytest.approx(0.7999)],
                    ["bench.window", pytest.approx(0.1999)]]
    assert trace.host_labels([5.0, 1_000_001.0]) == [
        "bench.window", "host: no traced event"]


def test_gap_labels_are_the_innermost_covering_event():
    """Against a scan of every host event: the shortest that covers the
    time, of equal ones the last to start."""
    import random

    rng = random.Random(7)
    ev = [_x("bench.window", 0, 10_000)]
    for i in range(400):
        start = rng.randrange(10_000)
        ev.append(_x(f"e{i}", start, rng.choice([5, 50, 500, 5_000]),
                     rng.choice(["cpu_op", "user_annotation",
                                 "cuda_runtime"])))
    trace = Trace(ev)
    points = [rng.uniform(-10, 10_010) for _ in range(300)]

    def scan(ts):
        cover = [(dur, -i, name) for i, (name, start, dur)
                 in enumerate(trace.host) if start <= ts <= start + dur]
        return min(cover)[2] if cover else "host: no traced event"

    assert trace.host_labels(points) == [scan(ts) for ts in points]
