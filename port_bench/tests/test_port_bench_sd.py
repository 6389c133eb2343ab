"""The SD v1.5 UNet's cell runs through the harness as new files only: in a
copy of the benchmark, its driver (``drivers/sd_sample.py``), reference,
kernel family and readers at a tiny SD configuration (widths 32-64, a 16 ×
16 latent, float32 stated), traced and not, on the CPU, with no file of
the copy edited and without the U-Net's geometry; a program with its
guidance rows swapped is not correct; the control, read from the driver,
fails the tiny cell's limits; and the two readers of this cell's own
arithmetic read hand-made traces, and nothing where the program's spans or
the attention kernels are absent."""

from __future__ import annotations

import copy
import hashlib
import json

import pytest

from port_bench.harness.cell import execute
from port_bench.harness.registry import Registry
from port_bench.harness.trace import Trace
from port_bench.reference import model as ref_model
from port_bench.tests import tiny
from port_bench.tests.control import control_reading

CELL = "sample-sd15-ddim50-cfg7-b8"
TINY_CELL = "tiny-sd"
# float32 on both sides over 3 guided steps: the program and the reference
# differ by the order of float32 sums alone (~1e-6 of the latent)
TINY_LIMITS = {"latent_err": 1e-4, "step1_err": 1e-4}
SD_METRICS = {"launches_per_step.sd", "device_ms_per_step.sd",
              "attention_roofline.sd", "attention_share.sd",
              "transformer_launches_per_step.sd", "idle_share.sd", "mfu.sd"}


def _hashes(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _sd_copy(tmp_path):
    """A copy of the benchmark with a tiny SD configuration and its cell
    added as new files and entries; (registry, hashes before)."""
    reg = tiny.make(tmp_path)
    bench = reg.dir
    before = _hashes(bench)
    conf = json.loads((bench / "configs" / "riffusion-sd15-unet.json")
                      .read_text())
    conf = copy.deepcopy(conf)
    conf["config"]["model"].update(block_out_channels=[32, 64, 64, 64],
                                   cross_attention_dim=32, sample_size=16)
    conf["config"]["sampling"]["dtype"] = "float32"
    conf["limits"] = TINY_LIMITS
    (bench / "configs" / "tiny-sd.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "sd15-ddim50-cfg7-b8.json")
                         .read_text())
    traffic.update(timesteps=3, num_samples=2)
    (bench / "traffic" / "tiny-sd.json").write_text(json.dumps(traffic))
    spec = json.loads(reg.spec_path.read_text())
    spec["configs"].append({"name": "tiny-sd", "source": "CPU test",
                            "file": "port_bench/configs/tiny-sd.json",
                            "reduced": [], "why": "CPU test"})
    spec["workloads"].append({"name": TINY_CELL, "config": "tiny-sd",
                              "traffic": "tiny-sd", "chips": 1,
                              "why": "CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    reg.spec_path.write_text(json.dumps(spec))
    return Registry(bench, reg.spec_path), before


@pytest.fixture
def no_geometry(monkeypatch):
    def refuse(cls, config):
        raise AssertionError("the SD driver built the U-Net's geometry")

    monkeypatch.setattr(ref_model.Geometry, "from_config",
                        classmethod(refuse))


@pytest.mark.parametrize("trace", [False, True])
def test_the_sd_cell_runs_as_new_files(tmp_path, no_geometry, trace):
    reg, before = _sd_copy(tmp_path)
    result, checks = execute(reg, TINY_CELL, 2 ** 33 + 21, 0.01, trace,
                             device="cpu")
    assert result["correct"] and result["attempted"] >= 1
    assert set(checks) == set(TINY_LIMITS)
    assert all(v < 1e-5 for v, _ in checks.values()), checks
    # the CPU trace holds no device kernels: only the host-clock reader
    # finds something to read
    want = {"mfu.sd"} if trace else {"sample_clips_per_min", "setup_s"}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    layer = {m["name"] for m in reg.metrics_of(TINY_CELL, "per_layer")}
    assert layer == SD_METRICS
    after = _hashes(reg.dir)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {"configs/tiny-sd.json",
                                        "traffic/tiny-sd.json"}


def test_swapped_guidance_rows_are_not_correct(tmp_path, monkeypatch):
    from ddim_audio_tpu_torch.runners import diffusion_runner

    real = diffusion_runner.guidance_rows

    def swapped(text, uncond, dtype=None):
        rows = real(text, uncond, dtype)
        return rows.roll(text.shape[0], dims=0)

    monkeypatch.setattr(diffusion_runner, "guidance_rows", swapped)
    reg, _ = _sd_copy(tmp_path)
    result, checks = execute(reg, TINY_CELL, 2 ** 33 + 22, 0.01, False,
                             device="cpu")
    assert not result["correct"]
    assert min(v for v, _ in checks.values()) > 100 * TINY_LIMITS[
        "latent_err"], checks


def test_the_control_is_read_from_the_driver(tmp_path):
    reg, _ = _sd_copy(tmp_path)
    reading = control_reading(reg, TINY_CELL, 2 ** 33 + 23, "cpu")
    assert set(reading) == set(TINY_LIMITS)
    assert all(reading[k] > 10 * TINY_LIMITS[k] for k in reading), reading


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


class _Run:
    def __init__(self, events, registry):
        self.trace = Trace(events)
        self.registry = registry
        self.facts = {"steps_traced": 2}


def _events(program=True, attention=True):
    """A traced chain of 2 steps: each with a transformer span holding 3
    launches and 1 launch outside it; device kernels of 100 µs, one an
    attention kernel a step when ``attention``."""
    ev = [_x("bench.window", 0, 1_000), _x("bench.chain", 0, 1_000)]
    for k in range(2):
        t0 = 100 + 400 * k
        if program:
            ev += [_x("ddim.sampler.step", t0, 300),
                   _x("ddim.sd.transformer", t0 + 10, 150)]
        for j in range(4):
            ev.append(_x("cudaLaunchKernel" if j % 2 else "cuLaunchKernel",
                         t0 + 20 + 60 * j, 5, cat="cuda_runtime"))
        name = ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_"
                "traits<40, 128, 64, 4>>(Flash_fwd_params)" if attention
                else "sm90_xmma_gemm_bf16bf16_bf16f32")
        ev += [_x(name, t0 + 50, 100, cat="kernel"),
               _x("ampere_bf16_s16816gemm", t0 + 150, 100, cat="kernel")]
    return ev


def test_the_sd_readers_on_made_traces():
    reg = Registry()
    launches = reg.metric("transformer_launches_per_step.sd")
    share = reg.metric("attention_share.sd")
    run = _Run(_events(), reg)
    assert launches.read(run) == 3.0
    assert share.read(run) == pytest.approx(50.0)
    assert launches.read(_Run(_events(program=False), reg)) is None
    assert share.read(_Run(_events(attention=False), reg)) is None
    fam = reg.kernel_family("attention")
    assert fam.NAMES.search("fmha_cutlassF_bf16_aligned_64x64_rf_sm80("
                            "PyTorchMemEffAttention::AttentionKernel<")
    assert not fam.NAMES.search("void cudnn::ops::nchwToNhwcKernel<")


def test_the_attention_bound_counts_each_call():
    """At the published shapes: 16 Transformer2Ds, 32 attention calls a
    forward, and the step's bound from their operations and bytes."""
    from port_bench.kernels import attention
    from port_bench.reference.sd_unet import SDConfig

    conf = Registry().config("riffusion-sd15-unet")
    sd = SDConfig.from_config(conf["config"])
    calls = attention.calls(sd, 64)
    assert len(calls) == 32
    assert sorted({(n, m) for n, m, _ in calls}) == [
        (64, 64), (64, 77), (256, 77), (256, 256), (1024, 77),
        (1024, 1024), (4096, 77), (4096, 4096)]

    class Run:
        config = conf
        rows, size = 16, 64
    Run.sd = sd
    self_4096 = 16 * 4 * 4096 * 4096 * 320 / 989e12
    assert attention.bound_per_step(Run) > 5 * self_4096
