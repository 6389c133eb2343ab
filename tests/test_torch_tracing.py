"""The port's host spans (``utils/tracing.py``) at the tiny config on the
CPU: outside a profiler ``span`` is one shared no-op; under
``torch.profiler`` a 2-step ``sample_last_only`` of 2 clips and a
``grad_accum`` 2 train step leave their ``ddim.*`` spans in the exported
Chrome trace, nested by their times; and the clips and the new parameters
are bit-equal with the profiler on and off. Imports no JAX."""

import contextlib
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.diffusion.schedules import make_schedule
from ddim_audio_tpu_torch.models.unet import ModelConfig, init_model
from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
from ddim_audio_tpu_torch.training.train_step import (init_train_state,
                                                      make_train_step)
from ddim_audio_tpu_torch.utils.tracing import span
from ddim_audio_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
CONFIG = "configs/audio_tiny.yml"


def _profiled(on: bool, trace_path):
    """A CPU profiler that exports its Chrome trace to trace_path on exit,
    or nothing."""
    if not on:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def profiled():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            yield
        prof.export_chrome_trace(str(trace_path))

    return profiled()


def _spans(trace_path) -> list:
    """[(name, start, end)] of the trace's ``ddim.*`` spans."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") == "user_annotation"
                  and e.get("ph") == "X" and e["name"].startswith("ddim."))


def _inside(spans, name, outer) -> list:
    return [s for s in spans if s[0] == name
            and outer[1] <= s[1] and s[2] <= outer[2]]


def _sample(tmp, on: bool):
    config = load_config(CONFIG)
    config.sampling.num_samples = 2
    folder = tmp / ("on" if on else "off")
    args = SimpleNamespace(seed=5, timesteps=2, skip_type="uniform", eta=0.0,
                           sample_type="generalized", image_folder=str(folder))
    runner = Diffusion(args, config, device="cpu")
    params = init_model(torch.Generator().manual_seed(0), runner.model_cfg,
                        device="cpu")
    with _profiled(on, tmp / "sample.json"):
        out = runner.sample_last_only(params)
    return out, folder


def _train(tmp, on: bool):
    config = load_config(CONFIG)
    config.training.grad_accum = 2
    # fewer blocks, and remat off (its first call imports torch's compiler
    # stack, ~3 s): the profiler records every op of a step, and the step's
    # spans depend on neither
    config.model.res = [1, 1, 1]
    config.model.transformers.kwargs.num_hidden_layers = 1
    cfg = dataclasses.replace(ModelConfig.from_config(config), remat=False)
    d = config.diffusion
    schedule = make_schedule(d.beta_schedule, d.beta_start, d.beta_end,
                             d.num_diffusion_timesteps)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    state, tx = init_train_state(params, config.optimization, use_ema=True)
    step = make_train_step(cfg, config, schedule.alphas_cumprod, tx)
    x0 = 0.5 * torch.randn((2, cfg.channels, config.model.t_size, cfg.f_size),
                           generator=torch.Generator().manual_seed(1))
    with _profiled(on, tmp / "train.json"):
        state, _ = step(state, x0, torch.Generator().manual_seed(7))
    return [p.clone() for p in tree_leaves(state.params)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sampling chain and the train step, each with the profiler off and
    on, and the spans of the traced ones."""
    tmp = tmp_path_factory.mktemp("tracing")
    out = {on: (_sample(tmp, on), _train(tmp, on)) for on in (False, True)}
    return SimpleNamespace(out=out, sample=_spans(tmp / "sample.json"),
                           train=_spans(tmp / "train.json"))


def test_span_is_one_shared_noop_outside_a_profiler():
    assert span("ddim.a") is span("ddim.b")
    with span("ddim.a"), span("ddim.a"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(span("ddim.a"), torch.profiler.record_function)
    assert span("ddim.a") is span("ddim.b")


def test_chain_spans_nest(runs):
    (chain,) = [s for s in runs.sample if s[0] == "ddim.runner.chain"]
    for name in ("ddim.runner.prepare", "ddim.sampler.loop",
                 "ddim.runner.finalize", "ddim.runner.filter",
                 "ddim.runner.to_host", "ddim.runner.export"):
        assert len(_inside(runs.sample, name, chain)) == 1, name
    (loop,) = _inside(runs.sample, "ddim.sampler.loop", chain)
    assert len(_inside(runs.sample, "ddim.sampler.step", loop)) == 2
    assert len([s for s in runs.sample if s[0] == "ddim.sampler.step"]) == 2


def test_export_spans_a_clip_each(runs):
    (export,) = [s for s in runs.sample if s[0] == "ddim.runner.export"]
    clips = _inside(runs.sample, "ddim.runner.export.clip", export)
    assert len(clips) == 2
    for clip in clips:
        for part in ("png", "wav"):
            assert len(_inside(runs.sample, f"ddim.runner.export.{part}",
                               clip)) == 1


def test_train_step_spans(runs):
    (step,) = [s for s in runs.train if s[0] == "ddim.train.step"]
    counts = {name: len(_inside(runs.train, f"ddim.train.{name}", step))
              for name in ("forward", "backward", "update")}
    assert counts == {"forward": 2, "backward": 2, "update": 1}
    assert len(runs.train) == 6  # nothing outside the step


@pytest.mark.parametrize("what", ["clips", "files", "params"])
def test_outputs_equal_with_profiler_on_and_off(runs, what):
    (off_clips, off_dir), off_params = runs.out[False]
    (on_clips, on_dir), on_params = runs.out[True]
    if what == "clips":
        np.testing.assert_array_equal(on_clips, off_clips)
    elif what == "files":
        for name in ("0_final.png", "1_final.png", "0_final.wav",
                     "1_final.wav"):
            assert (on_dir / name).read_bytes() == (
                off_dir / name).read_bytes(), name
    else:
        assert len(on_params) == len(off_params)
        for a, b in zip(on_params, off_params):
            assert torch.equal(a, b)
