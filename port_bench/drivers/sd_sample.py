"""Guided sampling window of the SD v1.5 UNet: one client calls
``Diffusion.sample_last_only(params, x, (text, uncond))`` chain after chain
(DDIM, classifier-free guidance on a doubled batch, the final latents
exported as ``.npy``), each with a new start noise and new text embeddings
from the seed and the run's one unconditional embedding; the window ends
at the end of the first chain that finishes after the run's seconds.
``sample_clips_per_min`` is the clips of those whole chains over their wall
time.

Set-up: the program's SD UNet is imported first (a program without it
fails here, at once), then seed-made weights on the card, the runner, and
one chain of one step at the cell's batch (the same shapes and runner
path, export included). With ``--trace 1`` one more chain runs under the
profiler after the window.

Check: after the window, ``check_clips`` clips of one finished chain drawn
from the seed, with their own start noise and embeddings, against the
float32 reference's guided chain (``reference/sd_unet.py``): the worst
clip's relative RMS error of the final latent (``latent_err``) and of the
latent after the first guided step (``step1_err``), the latter from the
runner's own sampler taking that one step. ``control`` reads the same
numbers of the reference in float8 e4m3 against itself in float32."""

from __future__ import annotations

import argparse
import copy
import gc
import os
import time

import numpy as np
import torch

from port_bench.harness.params import generator, make_params
from port_bench.harness.sd_work import forward_flops
from port_bench.harness.trace import WINDOW, span, traced
from port_bench.reference import check as ref_check
from port_bench.reference import sd_unet as ref

LIMITS = ("latent_err", "step1_err")


def _weights(run):
    """The cell's shapes and the seed-made fp32 weights on the device."""
    tr = run.traffic
    run.sd = ref.SDConfig.from_config(run.config["config"])
    run.batch, run.rows = tr["num_samples"], 2 * tr["num_samples"]
    run.size = run.sd.sample_size
    run.params = make_params(ref.param_spec(run.sd), run.seed, run.device)


def _runner(run, timesteps: int):
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
    from ddim_audio_tpu_torch.utils.namespace import dict2namespace

    tr = run.traffic
    raw = copy.deepcopy(run.config["config"])
    raw["sampling"]["num_samples"] = tr["num_samples"]
    raw["sampling"]["guidance_scale"] = tr["guidance_scale"]
    args = argparse.Namespace(
        seed=run.seed % (1 << 31), timesteps=timesteps,
        skip_type=tr["skip_type"], eta=tr["eta"],
        sample_type=tr["sample_type"], sequence=None,
        image_folder=os.path.join(run.tmp, "port_bench_latents"),
        log_path=run.tmp)
    return Diffusion(args, dict2namespace(raw), device=run.device)


def start_noise(run, index: int) -> torch.Tensor:
    s = run.sd
    shape = (run.batch, s.in_channels, s.sample_size, s.sample_size)
    return torch.randn(shape, generator=generator(run.device, run.seed, 2,
                                                  index), device=run.device)


def conditioning(run, index: int) -> tuple:
    """(text [N, tokens, dim] of chain ``index``'s prompts, the run's one
    unconditional [tokens, dim]): seed-made stand-ins for CLIP's."""
    shape = (run.sd.text_tokens, run.sd.cross_attention_dim)
    text = torch.randn((run.batch, *shape), device=run.device,
                       generator=generator(run.device, run.seed, 4, index))
    uncond = torch.randn(shape, device=run.device,
                         generator=generator(run.device, run.seed, 5))
    return text, uncond


def _chain(run, index: int):
    return run.runner.sample_last_only(run.params, start_noise(run, index),
                                       conditioning(run, index))


def setup(run):
    from ddim_audio_tpu_torch.models import sd_unet  # noqa: F401

    _weights(run)
    run.runner = _runner(run, run.traffic["timesteps"])
    run.log("set-up: weights and runner made")
    steps = run.runner.args.timesteps
    run.runner.args.timesteps = 1
    _chain(run, 1 << 30)
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
        run.outputs.append(_chain(run, len(times)))
        times.append(time.perf_counter() - c0)
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    run.log(f"chains {len(times)}: " + " ".join(f"{s:.3f}" for s in times)
            + f" s; window {wall:.3f} s")
    run.facts["wall_timed_s"] = wall
    run.facts["steps_timed"] = tr["timesteps"] * len(times)
    run.facts["flops_timed"] = (forward_flops(run.sd, run.rows, run.size)
                                * tr["timesteps"] * len(times))
    return {"sample_clips_per_min": 60.0 * tr["num_samples"] * len(times)
            / wall}


def trace(run):
    """One chain under the profiler."""
    out = {}
    with traced(out, run.device):
        with span(WINDOW), span("bench.chain"):
            _chain(run, -1)
    run.trace = out["trace"]
    run.facts["steps_traced"] = run.traffic["timesteps"]


def first_step(run, x, text, uncond) -> np.ndarray:
    """The latent after the first guided step of a chain from x, taken by
    the runner's own sampler (the call each step of a chain makes)."""
    from ddim_audio_tpu_torch.diffusion.schedules import (
        make_timestep_subsequence)

    r = run.runner
    seq = make_timestep_subsequence(r.num_timesteps, r.args.timesteps,
                                    r.args.skip_type)
    sampler, state, finalize = r._sampler_for_state(x)
    coeffs = sampler._coeff_arrays(r.schedule, seq, r.args.eta)
    with torch.no_grad():
        _, x1 = sampler._step(r._sampler_params(run.params, x, (text, uncond)),
                              state, coeffs, 0, None)
    return finalize(x1).float().cpu().numpy()


def reference_latents(run, x, text, uncond, ops=None, tf32=False) -> tuple:
    """(after the first step, final) latents of the reference's guided
    chain, on the host."""
    tr, conf = run.traffic, run.config["config"]
    model = ref.Model(run.sd, ops)
    abar = ref.alphas_cumprod(conf["diffusion"])
    with ref_check.float32_math(tf32):
        first, last = ref.guided_chain(model, run.params, x.float(),
                                       text.float(), uncond.float(), abar,
                                       tr["timesteps"], tr["guidance_scale"])
    return first.cpu(), last.cpu()


def _errors(got1, got, ref1, ref_last) -> dict:
    n = ref_last.shape[0]
    return {"latent_err": max(ref_check.rel_err(got[i], ref_last[i])
                              for i in range(n)),
            "step1_err": max(ref_check.rel_err(got1[i], ref1[i])
                             for i in range(n))}


def _free(run):
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(run) -> dict:
    """{name: (value, limit)} of the comparison with the reference."""
    tr = run.traffic
    rng = np.random.default_rng([run.seed % (1 << 63), 3])
    chain = int(rng.integers(len(run.outputs)))
    clips = np.sort(rng.permutation(tr["num_samples"])[:tr["check_clips"]])
    idx = torch.as_tensor(clips, device=run.device)
    got = run.outputs[chain][clips]
    x = start_noise(run, chain)[idx]
    text, uncond = conditioning(run, chain)
    text = text[idx]
    got1 = first_step(run, x, text, uncond)
    del run.runner, run.outputs
    _free(run)
    ref1, ref_last = reference_latents(run, x, text, uncond)
    compared = _errors(got1, got, ref1, ref_last)
    v = ref_last.double()
    rms = float(np.sqrt(np.square(got.astype(np.float64)).mean()))
    run.log(f"checked chain {chain}, clips {clips.tolist()}: {compared}; "
            f"the reference's final RMS {float(v.square().mean().sqrt()):.4g}"
            f", largest |x| {float(v.abs().max()):.4g}; the program's final "
            f"RMS {rms:.4g}")
    lim = run.config["limits"]
    return {k: (v, lim[k]) for k, v in compared.items()}


def control(run) -> dict:
    """The reference with float8 e4m3 operands (``ControlOps``) against
    itself in float32, on the first chain's first clips."""
    _weights(run)
    n = run.traffic["check_clips"]
    x = start_noise(run, 0)[:n]
    text, uncond = conditioning(run, 0)
    ref1, ref_last = reference_latents(run, x, text[:n], uncond)
    low1, low = reference_latents(run, x, text[:n], uncond,
                                  ops=ref.ControlOps())
    return _errors(low1.numpy(), low.numpy(), ref1, ref_last)
