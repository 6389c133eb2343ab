"""torch.profiler view of one optimizer step of the port, on the card.

    python -m ddim_audio_tpu_torch.tools.profile_train_step [--dtype float32|bfloat16]
                                                            [--steps 1] [--top 16]

Builds the audio.yml model (seed-made init weights) and its TrainState,
warms the train step up (batch 14 x [2, 1024, 256], ``grad_accum: 14``,
remat, seed-made data), then profiles ``--steps`` steps and prints, per
step: wall time without the profiler, device-busy time (the sum of every
device kernel) and its share of that wall time, host time in torch
operators, the number of device kernels, and the device time by kernel
name. Run it in a process of its own: the profiler leaves the host slower
for the rest of the process.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import torch

from ..config import load_config, resolve_dtype
from ..diffusion.schedules import make_schedule
from ..models.unet import ModelConfig, init_model
from ..training.train_step import init_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--top", type=int, default=16)
    args = ap.parse_args(argv)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    config = load_config("configs/audio.yml")
    cfg = dataclasses.replace(ModelConfig.from_config(config),
                              dtype=resolve_dtype(args.dtype))
    d = config.diffusion
    schedule = make_schedule(d.beta_schedule, d.beta_start, d.beta_end,
                             d.num_diffusion_timesteps)
    params = init_model(torch.Generator().manual_seed(0), cfg)
    state, tx = init_train_state(params, config.optimization,
                                 use_ema=bool(config.model.ema))
    step = make_train_step(cfg, config, schedule.alphas_cumprod, tx)
    gen = torch.Generator("cuda").manual_seed(3)
    x0 = 0.5 * torch.randn((config.training.batch_size, cfg.channels,
                            config.model.t_size, cfg.f_size), generator=gen,
                           device="cuda")
    state, _ = step(state, x0, gen)
    torch.cuda.synchronize()
    n = args.steps
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step(state, x0, gen)
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / n * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, x0, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    rows = prof.key_averages()
    dev = [(r.key, r.device_time_total / 1e3 / n, r.count / n) for r in rows
           if r.device_time_total > 0 and r.device_type.name == "CUDA"]
    busy = sum(d[1] for d in dev)
    host = sum(r.self_cpu_time_total for r in rows) / 1e3 / n
    print(f"train step, {args.dtype} compute, batch "
          f"{config.training.batch_size}, grad_accum "
          f"{config.training.grad_accum}, per step over {n}: wall without the "
          f"profiler {bare:.1f} ms, of which the device is busy {busy:.1f} ms "
          f"({100 * busy / bare:.1f}%) | under the profiler: wall {wall:.1f} "
          f"ms, host in torch operators {host:.1f} ms, device kernels "
          f"launched {sum(d[2] for d in dev):.0f}")
    for key, ms, count in sorted(dev, key=lambda d: -d[1])[:args.top]:
        print(f"  {ms:9.3f} ms  x{count:8.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
