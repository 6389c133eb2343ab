"""Sampling window: one client calls ``Diffusion.sample_last_only(params,
x)`` chain after chain, each with a new start noise from the seed; the
window ends at the end of the first chain that finishes after the run's
seconds. ``sample_clips_per_min`` is the clips of those whole chains over
their wall time.

Set-up: the program's runner, seed-made weights on the card, and one
chain of one denoiser step at the cell's batch (the same shapes, the same
runner path, export included). With ``--trace 1`` one more chain runs
under the profiler after the window.

Weights: ``harness.params.sampling_params``, whose ε stays near unit size
so that the walk's state stays bounded.

Check: after the window, a sample of the finished clips drawn from the
seed (``check_clips`` clips of one chain) against the float32 reference run
over the same start noise and weights: the worst clip's median span error
(``reference.check.clip_errors``) against the configuration's limit."""

from __future__ import annotations

import argparse
import copy
import gc
import os
import re
import time

import numpy as np
import torch

from port_bench.harness.params import generator, sampling_params
from port_bench.harness.trace import WINDOW, span, traced
from port_bench.harness.work import forward_flops
from port_bench.reference import check as ref_check
from port_bench.reference.model import param_spec

LIMITS = ("span_err_median",)
STEP_MARKER = re.compile(r"\bconv_head\w*_kernel")
END_MARKER = re.compile(r"\bconv_tail\w*_kernel")


def _runner(run, timesteps: int):
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
    from ddim_audio_tpu_torch.utils.namespace import dict2namespace

    tr = run.traffic
    raw = copy.deepcopy(run.config["config"])
    raw["sampling"]["num_samples"] = tr["num_samples"]
    raw["sampling"]["t_size"] = tr["t_size"]
    folder = os.path.join(run.tmp, "port_bench_clips")
    args = argparse.Namespace(
        seed=run.seed % (1 << 31), timesteps=timesteps,
        skip_type=tr["skip_type"], eta=tr["eta"],
        sample_type=tr["sample_type"], sequence=None, image_folder=folder,
        log_path=run.tmp)
    return Diffusion(args, dict2namespace(raw), device=run.device)


def start_noise(run, index: int) -> torch.Tensor:
    tr = run.traffic
    shape = (tr["num_samples"], run.geom.channels, tr["t_size"],
             run.geom.f_size)
    return torch.randn(shape, generator=generator(run.device, run.seed, 2,
                                                  index), device=run.device)


def setup(run):
    tr = run.traffic
    run.batch, run.t_size = tr["num_samples"], tr["t_size"]
    run.params = sampling_params(param_spec(run.geom), run.seed, run.device)
    run.runner = _runner(run, tr["timesteps"])
    run.log("set-up: weights and runner made")
    steps = run.runner.args.timesteps
    run.runner.args.timesteps = 1
    run.runner.sample_last_only(run.params, start_noise(run, 1 << 30))
    run.runner.args.timesteps = steps
    run.sync()


def window(run, seconds: float) -> dict:
    """Chains until ``seconds`` have passed; returns the end-to-end
    metrics."""
    tr = run.traffic
    run.outputs = []
    times = []
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        run.attempted += 1
        out = run.runner.sample_last_only(run.params,
                                          start_noise(run, len(times)))
        run.outputs.append(out)
        times.append(time.perf_counter() - c0)
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    run.log(f"chains {len(times)}: " + " ".join(f"{s:.3f}" for s in times)
            + f" s; window {wall:.3f} s")
    clips = tr["num_samples"] * len(times)
    run.facts["wall_timed_s"] = wall
    run.facts["steps_timed"] = tr["timesteps"] * len(times)
    run.facts["flops_timed"] = (forward_flops(run.geom, run.batch, run.t_size)
                                * tr["timesteps"] * len(times))
    return {"sample_clips_per_min": 60.0 * clips / wall}


def trace(run):
    """One chain under the profiler, the runner's export in a span of its
    own."""
    export = run.runner.export

    def spanned(*args, **kw):
        with span("runner.export"):
            return export(*args, **kw)

    run.runner.export = spanned
    out = {}
    with traced(out, run.device):
        with span(WINDOW), span("bench.chain"):
            run.runner.sample_last_only(run.params, start_noise(run, -1))
    run.trace = out["trace"]
    run.facts.update(steps_traced=run.traffic["timesteps"],
                     step_marker=STEP_MARKER, end_marker=END_MARKER)


def check(run) -> dict:
    """{name: (value, limit)} of the comparison with the reference."""
    tr = run.traffic
    rng = np.random.default_rng([run.seed % (1 << 63), 3])
    chain = int(rng.integers(len(run.outputs)))
    clips = np.sort(rng.permutation(tr["num_samples"])[:tr["check_clips"]])
    got = run.outputs[chain][clips]
    x = start_noise(run, chain)[torch.as_tensor(clips, device=run.device)]
    params = run.params
    del run.runner, run.outputs
    gc.collect()
    torch.cuda.empty_cache()
    compared, logged = ref_check.sample_error(run.config["config"], params, x,
                                              got, tr["timesteps"])
    v = np.square(got.astype(np.float64)).ravel()
    hot = np.partition(v, v.size - v.size // 1000)[v.size - v.size // 1000:]
    run.log(f"checked chain {chain}, clips {clips.tolist()}: {compared}, "
            f"{logged}; the clips' RMS {np.sqrt(v.mean()):.4g}, largest "
            f"|x| {np.sqrt(v.max()):.4g}, hottest 0.1% of values "
            f"{hot.sum() / v.sum():.4f} of the square")
    lim = run.config["limits"]
    return {k: (v, lim[k]) for k, v in compared.items()}
