"""A configuration of another model than the U-Net + FNet runs through the
harness as new files and new entries only: in a copy of the benchmark, a
toy model's configuration (float16 stated, none of the U-Net's keys, one
cut), traffic mix, driver, float32 reference and per-layer metric, and its
cells in ``BENCHMARK.json``, run on the CPU with no file of the copy
edited, and its control is read from its driver. And the two
configurations of the U-Net + FNet read what they read before: their
geometry and stated precisions, written out here."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import textwrap

import pytest

from port_bench.harness.cell import Run, execute
from port_bench.harness.registry import DTYPES, Registry, stated_precisions
from port_bench.harness.work import BYTES, PEAK_OPS
from port_bench.reference import model as ref_model
from port_bench.tests import tiny
from port_bench.tests.control import control_reading

TOY_CONFIG = {
    "source": "a toy residual MLP of the benchmark's tests",
    "reduced": ["depth"],
    "assumed": [],
    "deployment": "the CPU of a test run",
    "mfu_peak_tflops": {"toy": 0.001},
    "limits": {"out_err": 1e-4},
    "config": {"model": {"type": "toy", "width": 32, "depth": 2},
               "sampling": {"dtype": "float16"}},
}
TOY_TRAFFIC = {"driver": "toy", "batch": 8, "steps": 4, "perturb": 0.0}

TOY_DRIVER = '''
"""A toy driver: a residual MLP walked ``steps`` times a call, in float32
on the run's device, checked against its float64 reference."""

import importlib.util
import time
from pathlib import Path

import torch

from port_bench.harness.params import generator
from port_bench.harness.trace import WINDOW, span, traced

LIMITS = ("out_err",)

# a file beside the drivers of this copy of the benchmark, not the package
_spec = importlib.util.spec_from_file_location(
    "toy_reference", Path(__file__).parents[1] / "reference" / "toy.py")
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)


def _x(run, k):
    m = run.config["config"]["model"]
    return torch.randn(run.traffic["batch"], m["width"],
                       generator=generator(run.device, run.seed, 2, k),
                       device=run.device)


def _call(run, x):
    for _ in range(run.traffic["steps"]):
        for w in run.weights:
            x = x + 0.1 * torch.tanh(x @ w)
    return x * (1.0 + run.traffic["perturb"])


def setup(run):
    m = run.config["config"]["model"]
    g = generator(run.device, run.seed, 1)
    run.weights = list(torch.randn(m["depth"], m["width"], m["width"],
                                   generator=g, device=run.device)
                       / m["width"] ** 0.5)
    _call(run, _x(run, -1))


def window(run, seconds):
    run.outputs = []
    t0 = time.perf_counter()
    while True:
        run.attempted += 1
        run.outputs.append(_call(run, _x(run, len(run.outputs))))
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    tr, m = run.traffic, run.config["config"]["model"]
    calls = len(run.outputs)
    run.facts["wall_timed_s"] = wall
    run.facts["flops_timed"] = (2 * tr["batch"] * m["width"] ** 2
                                * m["depth"] * tr["steps"] * calls)
    return {"sample_clips_per_min": 60.0 * tr["batch"] * calls / wall}


def trace(run):
    out = {}
    with traced(out, run.device):
        with span(WINDOW):
            _call(run, _x(run, -2))
    run.trace = out["trace"]
    run.facts["steps_traced"] = run.traffic["steps"]


def check(run):
    k = len(run.outputs) - 1
    ref = reference.walk([w.double() for w in run.weights],
                         _x(run, k).double(), run.traffic["steps"])
    err = float((run.outputs[k].double() - ref).norm() / ref.norm())
    return {"out_err": (err, run.config["limits"]["out_err"])}


def control(run):
    """The reference in bfloat16 against itself in float64."""
    setup(run)
    x = _x(run, 0)
    low = reference.walk([w.bfloat16() for w in run.weights], x.bfloat16(),
                         run.traffic["steps"]).double()
    ref = reference.walk([w.double() for w in run.weights], x.double(),
                         run.traffic["steps"])
    return {"out_err": float((low - ref).norm() / ref.norm())}
'''

TOY_REFERENCE = '''
"""The toy model's walk in float64, written from its equation."""


def walk(weights, x, steps):
    for _ in range(steps):
        for w in weights:
            x = x + 0.1 * (x @ w).tanh()
    return x
'''

TOY_METRIC = '''
"""The toy walk's FLOPs over the window's wall time, in % of its peak."""

from port_bench.harness import readers


def read(run):
    return readers.mfu(run)
'''

TOY_CELLS = ("toy-sample", "toy-broken")


def _hashes(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _add(path, text: str) -> None:
    assert not path.exists(), path
    path.write_text(text)


def _toy_copy(tmp_path):
    """A copy of the benchmark with the toy model added as new files and
    entries; (registry, the hashes of the copy's files before)."""
    reg = tiny.make(tmp_path)
    bench = reg.dir
    before = _hashes(bench)
    _add(bench / "configs" / "toy-other.json", json.dumps(TOY_CONFIG))
    _add(bench / "traffic" / "toy-sample.json", json.dumps(TOY_TRAFFIC))
    _add(bench / "traffic" / "toy-broken.json",
         json.dumps(dict(TOY_TRAFFIC, perturb=0.01)))
    _add(bench / "drivers" / "toy.py", textwrap.dedent(TOY_DRIVER))
    _add(bench / "reference" / "toy.py", textwrap.dedent(TOY_REFERENCE))
    _add(bench / "metrics" / "mfu.toy.py", textwrap.dedent(TOY_METRIC))
    spec = json.loads(reg.spec_path.read_text())
    spec["configs"].append({
        "name": "toy-other", "source": TOY_CONFIG["source"],
        "file": "port_bench/configs/toy-other.json", "reduced": ["depth"],
        "why": "CPU test"})
    spec["workloads"] += [{"name": c, "config": "toy-other", "traffic": c,
                           "chips": 1, "why": "CPU test"} for c in TOY_CELLS]
    for m in spec["end_to_end"]:
        if m["name"] == "sample_clips_per_min":
            m["workloads"] += list(TOY_CELLS)
    spec["per_layer"].append({
        "name": "mfu.toy", "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "whole step",
        "moves": "sample_clips_per_min", "workloads": list(TOY_CELLS)})
    reg.spec_path.write_text(json.dumps(spec))
    return Registry(bench, reg.spec_path), before


def _no_geometry(monkeypatch):
    def refuse(cls, config):
        raise AssertionError("a driver of another model built the geometry")

    monkeypatch.setattr(ref_model.Geometry, "from_config",
                        classmethod(refuse))


@pytest.mark.parametrize("trace", [False, True])
def test_another_model_runs_as_new_files(tmp_path, monkeypatch, trace):
    reg, before = _toy_copy(tmp_path)
    _no_geometry(monkeypatch)
    result, checks = execute(reg, "toy-sample", 2 ** 33 + 5, 0.01, trace,
                             device="cpu")
    assert result["correct"] and result["attempted"] >= 1
    assert set(checks) == {"out_err"} and checks["out_err"][0] < 1e-6
    want = {"mfu.toy"} if trace else {"sample_clips_per_min", "setup_s"}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    after = _hashes(reg.dir)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "configs/toy-other.json", "traffic/toy-sample.json",
        "traffic/toy-broken.json", "drivers/toy.py", "reference/toy.py",
        "metrics/mfu.toy.py"}


def test_another_models_answer_altered_is_not_correct(tmp_path):
    reg, _ = _toy_copy(tmp_path)
    result, checks = execute(reg, "toy-broken", 2 ** 33 + 6, 0.01, False,
                             device="cpu")
    assert not result["correct"] and checks["out_err"][0] > 1e-3


def test_another_models_control_is_read_from_its_driver(tmp_path):
    reg, _ = _toy_copy(tmp_path)
    reading = control_reading(reg, "toy-sample", 2 ** 33 + 7, "cpu")
    assert reading["out_err"] > reg.config("toy-other")["limits"]["out_err"]


def test_another_model_finds_its_pieces(tmp_path):
    reg, _ = _toy_copy(tmp_path)
    conf = reg.config("toy-other")
    assert conf["declared"] == {"sample_dtype": "fp16", "tap_int8": False,
                                "act_store": None, "strided_int8": False}
    assert conf["reduced"] == ["depth"]
    assert set(conf["limits"]) >= set(reg.driver("toy").LIMITS)
    assert "toy" in conf["mfu_peak_tflops"]
    e2e = [m["name"] for m in reg.metrics_of("toy-sample", "end_to_end")]
    assert e2e == ["sample_clips_per_min", "setup_s"]
    layer = [m["name"] for m in reg.metrics_of("toy-sample", "per_layer")]
    assert layer == ["mfu.toy"]
    audio = [m["name"] for m in Registry().spec["per_layer"]]
    assert not set(layer) & set(audio)
    run = Run(reg, reg.cell("toy-sample"), 1, "cpu")
    assert run.mode == "toy" and "geom" not in vars(run)


@pytest.mark.parametrize("config,want", [
    ({"model": {"dtype": "float16"}}, "fp16"),
    ({"model": {"dtype": "bfloat16"}, "sampling": {}}, "bf16"),
    ({"model": {"type": "toy"}}, "fp32"),
    ({"model": {"dtype": "float32"}, "sampling": {"dtype": "float16"}},
     "fp16"),
])
def test_precisions_of_a_tree_without_int8(config, want):
    assert set(DTYPES.values()) <= set(BYTES) & set(PEAK_OPS)
    assert stated_precisions(config) == {
        "sample_dtype": want, "tap_int8": False, "act_store": None,
        "strided_int8": False}


# What the U-Net + FNet's configurations read before runs built their
# geometry lazily: the geometry and the stated precisions.
AUDIO_GEOM = {"channels": 2, "f_size": 256, "ch": (32, 64, 96, 128, 192, 256),
              "res": (2, 2, 3, 3, 3, 3), "num_timesteps": 1000,
              "fnet_hidden": 512, "fnet_layers": 12,
              "fnet_intermediate": 2048, "fnet_channels": 512,
              "ln_eps": 1e-06, "dropout": 0.1}
TINY_GEOM = {"channels": 2, "f_size": 16, "ch": (8, 16, 24), "res": (1, 1, 2),
             "num_timesteps": 50, "fnet_hidden": 32, "fnet_layers": 2,
             "fnet_intermediate": 64, "fnet_channels": 32, "ln_eps": 1e-06,
             "dropout": 0.1}
WIDTHS = {
    "int8_taps_max_width": 96,
    "int8_taps_max_width_from": "configs/audio.yml sampling.tap_int8's "
    "comment: int8 taps at C <= 64 resblocks and the slim-format C = 96",
    "act_store_max_width": 128,
    "act_store_max_width_from": "the program's int8 storage stages s0-s3 "
    "(widths 32-128), where sampling.act_store is int8",
    "strided_int8_transitions": [[32, 64, "down"], [64, 32, "up"],
                                 [256, 192, "up"]],
    "strided_int8_transitions_from": "the transitions that "
    "sampling.strided_int8 true sets to int8 taps at this config's widths: "
    "down 32->64, up 64->32, up 256->192"}
AUDIO_DECLARED = {**WIDTHS, "sample_dtype": "bf16", "tap_int8": True,
                  "act_store": None, "strided_int8": False}
TINY_DECLARED = {**WIDTHS, "sample_dtype": "fp32", "tap_int8": False,
                 "act_store": None, "strided_int8": False}


@pytest.mark.parametrize("cells,geom,declared", [
    (("train-b14", "sample-ddim100-b8"), AUDIO_GEOM, AUDIO_DECLARED),
    (("tiny-train", "tiny-sample"), TINY_GEOM, TINY_DECLARED),
])
def test_the_unet_reads_what_it_read(tmp_path, cells, geom, declared):
    reg = Registry() if cells[0] == "train-b14" else tiny.make(tmp_path)
    for name in cells:
        cell = reg.cell(name)
        run = Run(reg, cell, 2 ** 34 + 1, "cpu")
        assert "geom" not in vars(run)
        assert dataclasses.asdict(run.geom) == geom
        assert run.geom is run.geom
        assert reg.config(cell["config"])["declared"] == declared
