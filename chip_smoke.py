#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``ddim_audio_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ddim_audio_tpu_torch/csrc``
with nvcc (sm_90a) and runs, each phase on its own line:

1. device: requires CUDA, prints the card's name and power limit, turns TF32
   off for the plain references;
2. build: compiles the kernels and prints the build seconds;
3. kernels vs their plain PyTorch twins at every production stage shape, in
   fp32 and bf16, with the kernel and twin times from CUDA events;
4. full-width forward of the audio.yml model (47,155,266 params, seed-made
   weights with non-zero final GroupNorm weights) at [1, 2, 8192, 256]: the
   kernel route against the fp32 plain route, and the launch counts of one
   forward;
5. the slice: the runner's ``sample_last_only`` for 2 clips at 10 DDIM steps
   in bf16 (tap_int8 off), with the launch counts of that run and the files
   written; then 10-step chains, bf16 kernels against the fp32 plain chain
   from the same x_T, on init weights (the JAX package's chain guard, 44 dB)
   and on the non-zero-GN3 weights (41 dB, see SNR_CHAIN_GN3_BF16_DB).

Every failure raises and the script exits non-zero. The last two lines are
the per-kernel JSON summary and ``{"ok": true, "device": {...}}``. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np

# Stated tolerances (relative = max|kernel − twin| / max|twin|).
TOL_FP32 = 1e-4
TOL_BF16 = 2e-2
TOL_STATS = 1e-3
SNR_FWD_FP32_DB = 90.0
SNR_FWD_BF16_DB = 38.0
SNR_CHAIN_BF16_DB = 44.0
# The chain on non-zero GN3 weights, where every resblock conv counts: the
# kernel chain read 42.62 dB and the plain bf16 chain 39.92 dB on an H100, so
# a floor between them catches a kernel fault of a few dB.
SNR_CHAIN_GN3_BF16_DB = 41.0
PARAMS_AUDIO_YML = 47_155_266

# Production stage shapes at [1, 2, 8192, 256] (T, F, C), and transitions
# (T_in, F_in, C_in, C_out) of the down path.
STAGES = [(8192, 256, 32), (4096, 128, 64), (2048, 64, 96), (1024, 32, 128),
          (512, 16, 192), (256, 8, 256)]
DOWNS = [(8192, 256, 32, 64), (4096, 128, 64, 96), (2048, 64, 96, 128),
         (1024, 32, 128, 192), (512, 16, 192, 256)]

REPLACES = {
    "conv3x3_flat": ("ddim_audio_tpu_torch/csrc/conv3x3.cu",
                     "ddim_audio_tpu/ops/pallas/conv_flat.py:235"),
    "conv_down_flat": ("ddim_audio_tpu_torch/csrc/conv_strided.cu",
                       "ddim_audio_tpu/ops/pallas/conv_strided.py:182"),
    "conv_up_flat": ("ddim_audio_tpu_torch/csrc/conv_strided.cu",
                     "ddim_audio_tpu/ops/pallas/conv_strided.py:512"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Fail(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise Fail(msg)


def cuda_time(fn, n: int = 10, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events over n calls after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def rel_err(out, ref) -> tuple[float, float]:
    d = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return d, d / max(scale, 1e-30)


def snr_db(out, ref) -> float:
    ref = ref.double()
    err = ((out.double() - ref) ** 2).mean().item()
    return 10 * math.log10((ref ** 2).mean().item() / max(err, 1e-300))


# ---------------------------------------------------------------- phases --

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise Fail("torch.cuda.is_available() is False: this smoke run needs "
                   "an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    # the plain references run in true fp32 (cuDNN convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    return card


def phase_build():
    from ddim_audio_tpu_torch.ops import _cuda

    path, seconds, nvcc_log = _cuda.build()
    _cuda.kernels()
    regs = [ln.strip() for ln in nvcc_log.splitlines()
            if "registers" in ln or "spill" in ln]
    for ln in regs:
        log(f"[build]   ptxas: {ln}")
    log(f"[build] nvcc sm_90a -> {path.name} in {seconds:.2f} s")
    return seconds


def _kernel_cases(torch):
    """(name, label, make(dtype) -> (args, kwargs), kernel, twin) at the
    production shapes, B = 1, every fusion of the main path switched on."""
    from ddim_audio_tpu_torch.ops.conv_flat import (conv3x3_flat,
                                                    conv3x3_flat_plain)
    from ddim_audio_tpu_torch.ops.conv_strided import (conv_down_flat,
                                                       conv_down_flat_plain,
                                                       conv_up_flat,
                                                       conv_up_flat_plain)

    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    cases = []
    for t, f, c in STAGES:
        x, w, res = rnd(1, t, f * c), rnd(3, 3, c, c, scale=(9 * c) ** -0.5), \
            rnd(1, t, f * c)
        pre, add = (1 + 0.1 * rnd(1, c), 0.1 * rnd(1, c)), rnd(1, c)

        def make(dt, x=x, w=w, res=res, pre=pre, add=add, c=c):
            return (x.to(dt), w.to(dt)), dict(
                c=c, residual=res.to(dt), pre=pre, add=add, pre_silu=True,
                post_silu=True, want_stats=True)
        cases.append(("conv3x3_flat", f"T{t} F{f} C{c}", make, conv3x3_flat,
                      conv3x3_flat_plain))
    for t, f, ci, co in DOWNS:
        x, w, b = (rnd(1, t, f * ci), rnd(4, 4, ci, co, scale=(16 * ci) ** -0.5),
                   rnd(co))

        def make(dt, x=x, w=w, b=b, ci=ci, co=co):
            return (x.to(dt), w.to(dt), b), dict(c_in=ci, c_out=co,
                                                 want_stats=True)
        cases.append(("conv_down_flat", f"T{t} F{f} {ci}->{co}", make,
                      conv_down_flat, conv_down_flat_plain))
    for t, f, co, ci in DOWNS:  # up runs each transition in reverse
        x, w, b, res = (rnd(1, t // 2, (f // 2) * ci),
                        rnd(4, 4, ci, co, scale=(4 * ci) ** -0.5), rnd(co),
                        rnd(1, t, f * co))

        def make(dt, x=x, w=w, b=b, res=res, ci=ci, co=co):
            return (x.to(dt), w.to(dt), b), dict(
                c_in=ci, c_out=co, residual=res.to(dt), want_stats=True)
        cases.append(("conv_up_flat", f"T{t // 2} F{f // 2} {ci}->{co}", make,
                      conv_up_flat, conv_up_flat_plain))
    return cases


def phase_kernels(summary):
    import torch

    for name, label, make, kern, twin in _kernel_cases(torch):
        for dtype, tol, dt in ((torch.float32, TOL_FP32, "fp32"),
                               (torch.bfloat16, TOL_BF16, "bf16")):
            pos, kw = make(dtype)
            out, s1, s2 = kern(*pos, **kw)
            ref, r1, r2 = twin(*pos, **kw)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            srel = max(rel_err(s1, r1)[1], rel_err(s2, r2)[1])
            ms = cuda_time(lambda: kern(*pos, **kw))
            plain_ms = cuda_time(lambda: twin(*pos, **kw))
            log(f"[kernels] {name:15s} {label:22s} {dt} max_abs {err:.3e} "
                f"rel {rel:.3e} stats rel {srel:.3e} | kernel {ms:.3f} ms, "
                f"twin {plain_ms:.3f} ms")
            require(rel <= tol, f"{name} {label} {dt}: rel err {rel:.3e} > "
                    f"{tol}")
            require(srel <= TOL_STATS, f"{name} {label} {dt}: stats rel err "
                    f"{srel:.3e} > {TOL_STATS}")
            entry = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                              "plain_ms": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if dtype == torch.bfloat16:  # the main path's dtype
                entry["ms"] += ms
                entry["plain_ms"] += plain_ms


def _audio_params(torch):
    """audio.yml config (fp32 compute) and seed-made weights with non-zero
    final GroupNorm weights (zero-init GN3 makes every resblock the identity
    and would hide conv errors)."""
    from ddim_audio_tpu_torch.config import load_config
    from ddim_audio_tpu_torch.models.unet import (ModelConfig, count_params,
                                                  init_model)

    config = load_config("configs/audio.yml")
    cfg = ModelConfig.from_config(config)
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, cfg, device="cuda")
    n = count_params(params)
    require(n == PARAMS_AUDIO_YML, f"param count {n} != {PARAMS_AUDIO_YML}")
    for mod in ("down_modules", "up_modules"):
        for stage in params[mod]["stages"]:
            for block in stage["blocks"]:
                g = block["norm3"]["g"]
                g.copy_(1.0 + 0.2 * torch.randn(g.shape, generator=gen).cuda())
    return config, cfg, params


def phase_forward(cfg, params):
    import dataclasses

    import torch

    from ddim_audio_tpu_torch.models.unet import (apply_model,
                                                  apply_model_flat_io,
                                                  flat_io_adapters,
                                                  prepare_params)
    from ddim_audio_tpu_torch.ops import launch_counts, reset_launch_counts

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 2, 8192, 256), generator=gen).cuda()
    t = torch.tensor([500], device="cuda")
    to_flat, from_flat = flat_io_adapters(cfg)
    xf = to_flat(x).contiguous()
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    log(f"[forward] audio.yml, {PARAMS_AUDIO_YML} params, x [1, 2, 8192, 256], "
        "t [500], non-zero GN3 weights")

    # bf16 runs take the weights prepared once, as the runner passes them
    p16 = prepare_params(params, torch.bfloat16)
    ref = apply_model(params, x, t, cfg)
    for name, c, p, thresh in (("fp32", cfg, params, SNR_FWD_FP32_DB),
                               ("bf16", cfg16, p16, SNR_FWD_BF16_DB)):
        reset_launch_counts()
        out = from_flat(apply_model_flat_io(p, xf, t, c))
        torch.cuda.synchronize()
        counts = launch_counts()
        require(bool(torch.isfinite(out).all()), f"{name} forward not finite")
        snr = snr_db(out, ref)
        log(f"[forward] kernel route {name} vs fp32 plain: SNR {snr:.2f} dB "
            f"(>= {thresh}) | launches {counts}")
        require(snr >= thresh, f"{name} forward SNR {snr:.2f} < {thresh} dB")
        require(counts == {"conv3x3_flat": 66, "conv_down_flat": 5,
                           "conv_up_flat": 5},
                f"launches per forward {counts} != 66/5/5")
    ref16 = apply_model(p16, x, t, cfg16)
    log(f"[forward] plain route bf16 vs fp32 plain: SNR "
        f"{snr_db(ref16, ref):.2f} dB (for comparison)")
    times = {
        "kernel route bf16": lambda: apply_model_flat_io(p16, xf, t, cfg16),
        "kernel route fp32": lambda: apply_model_flat_io(params, xf, t, cfg),
        "plain route bf16": lambda: apply_model(p16, x, t, cfg16),
        "plain route fp32": lambda: apply_model(params, x, t, cfg),
    }
    for label, fn in times.items():
        log(f"[forward] {label}: {cuda_time(fn, n=5, warmup=1):.2f} ms / "
            "forward")


def phase_slice(summary, config, cfg, params):
    import os
    from types import SimpleNamespace

    import torch

    from ddim_audio_tpu_torch.diffusion.schedules import \
        make_timestep_subsequence
    from ddim_audio_tpu_torch.models.unet import apply_model
    from ddim_audio_tpu_torch.ops import launch_counts, reset_launch_counts
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
    from ddim_audio_tpu_torch.sampling.driver import ScanSampler

    steps, clips = 10, 2
    log(f"[slice] override: sampling.tap_int8 {config.sampling.tap_int8} -> "
        "False (int8 taps are not ported yet); sampling.num_samples "
        f"{config.sampling.num_samples} -> 1 (clips run one at a time); "
        f"sampling.dtype {config.sampling.dtype}")
    config.sampling.tap_int8 = False
    config.sampling.num_samples = 1

    def args_for(seed, folder):
        return SimpleNamespace(seed=seed, timesteps=steps, skip_type="uniform",
                               eta=0.0, sample_type="generalized",
                               image_folder=folder)

    with tempfile.TemporaryDirectory() as tmp:
        runners = [Diffusion(args_for(k, os.path.join(tmp, f"clip{k}")),
                             config, device="cuda") for k in range(clips)]
        require(runners[0].eval_cfg.dtype == torch.bfloat16,
                "eval config is not bf16")
        walls = []
        torch.cuda.synchronize()
        reset_launch_counts()
        for runner in runners:  # the main path: sample_last_only per clip
            t0 = time.perf_counter()
            out = runner.sample_last_only(params)
            walls.append(time.perf_counter() - t0)
            require(out.shape == (1, 2, 8192, 256), f"sample shape {out.shape}")
            require(bool(np.isfinite(out).all()), "sample not finite")
        counts = launch_counts()
        want = {"conv3x3_flat": 66 * steps * clips,
                "conv_down_flat": 5 * steps * clips,
                "conv_up_flat": 5 * steps * clips}
        log(f"[slice] sample_last_only x{clips} (bf16, {steps} DDIM steps): "
            f"host wall {', '.join(f'{w:.3f}' for w in walls)} s per clip "
            f"(denoise + PNG/WAV export included) | launches {counts}")
        require(counts == want, f"main-path launches {counts} != {want}")
        for name, n in counts.items():
            summary.setdefault(name, {})["launches"] = n
        for k in range(clips):
            for ext in ("png", "wav"):
                path = os.path.join(tmp, f"clip{k}", f"0_final.{ext}")
                require(os.path.getsize(path) > 0, f"{path} empty")
        log(f"[slice] wrote 0_final.png/.wav for {clips} clips")

    # The chain guard runs on init weights, as the JAX package's own
    # production-chain guard (tpu_tests/test_tpu_fullscale.py:123-145): GN3 = 0
    # there, so every resblock is the identity and the bf16 residual stream is
    # not re-rounded 30 times per forward. The non-zero-GN3 weights of the
    # forward phase run the same chain as a second check, in which every
    # resblock conv counts; the plain bf16 chain is printed for comparison.
    from ddim_audio_tpu_torch.models.unet import init_model, prepare_params

    runner = runners[0]
    seq = make_timestep_subsequence(runner.num_timesteps, steps, "uniform")
    x = runner.start_noise()
    sampler, xs, finalize = runner._sampler_for_state(x)
    cfg16 = runner.eval_cfg
    init_params = init_model(torch.Generator().manual_seed(0), cfg,
                             device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def chain(smp, x0, p):
        smp.sample_last(x0, seq[:1], runner.schedule, params=p)  # warm-up
        start.record()
        out = smp.sample_last(x0, seq, runner.schedule, params=p)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    plain32 = ScanSampler(lambda p, xx, t: apply_model(p, xx, t, cfg))
    plain16 = ScanSampler(lambda p, xx, t: apply_model(p, xx, t, cfg16))
    for label, p, floor in (("init weights (GN3 = 0)", init_params,
                             SNR_CHAIN_BF16_DB),
                            ("non-zero GN3 weights", params,
                             SNR_CHAIN_GN3_BF16_DB)):
        p16 = prepare_params(p, cfg16.dtype)  # once per run, as the runner
        out_k, ms_k = chain(sampler, xs, p16)
        out_32, ms_32 = chain(plain32, x, p)
        out_16, ms_16 = chain(plain16, x, p16)
        require(bool(torch.isfinite(out_k).all()), "kernel chain not finite")
        snr = snr_db(finalize(out_k), out_32)
        log(f"[slice] {steps}-step chain, {label}: bf16 kernels {ms_k:.1f} ms "
            f"per clip ({ms_k / steps:.2f} ms per step) | fp32 plain "
            f"{ms_32:.1f} ms ({ms_32 / steps:.2f}) | bf16 plain {ms_16:.1f} "
            f"ms ({ms_16 / steps:.2f})")
        log(f"[slice] {steps}-step chain, {label}: bf16 kernels vs fp32 plain "
            f"SNR {snr:.2f} dB (>= {floor}); bf16 plain vs fp32 plain "
            f"{snr_db(out_16, out_32):.2f} dB (for comparison)")
        require(snr >= floor, f"chain SNR ({label}) {snr:.2f} < {floor} dB")


def main() -> int:
    import torch

    summary = {}
    try:
        card = phase_device()
        phase_build()
        phase_kernels(summary)
        config, cfg, params = _audio_params(torch)
        phase_forward(cfg, params)
        phase_slice(summary, config, cfg, params)
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        log(f"[FAIL] {type(e).__name__}: {e}")
        return 1
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, **summary[name]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
