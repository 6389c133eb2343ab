"""A copy of the benchmark at configs/audio_tiny.yml's geometry, for CPU
tests: the same harness, drivers, readers and reference, with a tiny
configuration, tiny traffic mixes and their cells."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import yaml

from port_bench.harness.registry import BENCH_DIR, Registry

REPO = BENCH_DIR.parent
LIMITS = {"span_err_median": 1e-4, "loss_gap": 1e-4, "grad_gap": 1e-3,
          "move_gap": 1e-2, "ema_gap_median": 1e-2}
SAMPLE = {"driver": "sample", "sample_type": "generalized", "timesteps": 4,
          "skip_type": "uniform", "eta": 0.0, "num_samples": 2, "t_size": 16,
          "check_clips": 2}
TRAIN = {"driver": "train", "batch": 4, "grad_accum": 1, "t_size": 8,
         "x0_scale": 0.5, "checked_steps": 3, "traced_steps": 1,
         "reference_chunk": 2}


def tiny_config() -> dict:
    raw = yaml.safe_load(open(REPO / "configs" / "audio_tiny.yml"))
    raw.pop("define", None)
    return raw


def make(tmp: Path) -> Registry:
    """A registry over a copy of the benchmark in ``tmp`` with the cells
    ``tiny-sample`` and ``tiny-train``."""
    bench = tmp / "port_bench"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    conf = json.load(open(bench / "configs" / "ddim-audio.json"))
    conf = dict(copy.deepcopy(conf), config=tiny_config(), limits=LIMITS)
    json.dump(conf, open(bench / "configs" / "tiny.json", "w"))
    json.dump(SAMPLE, open(bench / "traffic" / "tiny-sample.json", "w"))
    json.dump(TRAIN, open(bench / "traffic" / "tiny-train.json", "w"))
    spec = json.load(open(REPO / "BENCHMARK.json"))
    spec["workloads"] += [
        {"name": "tiny-sample", "config": "tiny", "traffic": "tiny-sample",
         "chips": 1, "why": "CPU test"},
        {"name": "tiny-train", "config": "tiny", "traffic": "tiny-train",
         "chips": 1, "why": "CPU test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            if m["name"].startswith("train_") or m["name"].endswith(".train"):
                m["workloads"].append("tiny-train")
            else:
                m["workloads"].append("tiny-sample")
    json.dump(spec, open(tmp / "BENCHMARK.json", "w"))
    return Registry(bench, tmp / "BENCHMARK.json")
