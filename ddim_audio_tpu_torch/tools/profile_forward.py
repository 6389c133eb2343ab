"""torch.profiler view of one denoiser forward of the port, on the card.

    python -m ddim_audio_tpu_torch.tools.profile_forward \
        [--route production|int8_store|float|plain] [--forwards 3] [--top 12]

Builds the audio.yml model with seed-made weights (non-zero final GroupNorm
weights), warms the route up, profiles ``--forwards`` forwards at
[1, 2, 8192, 256] and prints, per forward (``int8_store``: the production
configuration plus ``sampling.act_store: int8`` and
``sampling.strided_int8: true``): wall time, device-busy time (the
sum of every device kernel), host time in torch operators and the device time
by kernel name. The busy share is device-busy time over the wall time
measured without the profiler. Run it in a process of its own and time nothing after it: the
profiler leaves the host slower for the rest of the process.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import torch

from ..config import production_eval_cfg
from ..models.unet import (apply_model, apply_model_flat_io, flat_io_adapters,
                           prepare_params)
from . import audio_model, forward_input


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--route", default="production",
                    choices=["production", "int8_store", "float", "plain"])
    ap.add_argument("--forwards", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    config, cfg, params = audio_model()
    x, t = forward_input(cfg)
    to_flat, _ = flat_io_adapters(cfg)
    xf = to_flat(x).contiguous()
    if args.route == "int8_store":
        config.sampling.act_store, config.sampling.strided_int8 = "int8", True
    if args.route in ("production", "int8_store"):
        c = production_eval_cfg(config, cfg)
    else:
        c = dataclasses.replace(cfg, dtype=torch.bfloat16)
    p = prepare_params(params, c)
    if args.route == "plain":
        def fwd():
            return apply_model(p, x, t, c)
    else:
        def fwd():
            return apply_model_flat_io(p, xf, t, c)
    for _ in range(3):
        fwd()
    torch.cuda.synchronize()
    n = args.forwards
    t0 = time.perf_counter()
    for _ in range(n):
        fwd()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / n * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fwd()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    rows = prof.key_averages()
    dev = [(r.key, r.device_time_total / 1e3 / n, r.count / n) for r in rows
           if r.device_time_total > 0 and r.device_type.name == "CUDA"]
    busy = sum(d[1] for d in dev)
    host = sum(r.self_cpu_time_total for r in rows) / 1e3 / n
    print(f"route {args.route}, bf16, per forward over {n}: wall without the "
          f"profiler {bare:.2f} ms, of which the device is busy {busy:.2f} ms "
          f"({100 * busy / bare:.1f}%) | under the profiler: wall {wall:.2f} "
          f"ms, host in torch operators {host:.2f} ms, device kernels "
          f"launched {sum(d[2] for d in dev):.0f}")
    for key, ms, count in sorted(dev, key=lambda d: -d[1])[:args.top]:
        print(f"  {ms:8.3f} ms  x{count:6.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
