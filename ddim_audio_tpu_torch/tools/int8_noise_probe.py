"""Where the int8-tap noise of the production forward comes from, on the card.

    python -m ddim_audio_tpu_torch.tools.int8_noise_probe

Runs the audio.yml production forward (bf16, int8 taps at C <= 96) at
[1, 2, 8192, 256] against the fp32 plain route and prints its SNR with: the
CUDA kernels; the plain twins in their place, with the kernel's quantisation
group, the TPU kernel's (64 rows × all F, 2-row halo) and finer ones; weight
quantisation alone; and final GroupNorm
weights scaled by 1, 0.3, 0.1 and 0 (the init weights, where every resblock
branch is multiplied by zero). It separates a kernel fault from what the
arithmetic gives.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

from ..config import production_eval_cfg
from ..models import unet
from ..ops import twin_route
from . import audio_model, forward_input, snr_db


def main() -> int:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    config, cfg, params = audio_model()
    x, t = forward_input(cfg)
    to_flat, from_flat = unet.flat_io_adapters(cfg)
    xf = to_flat(x).contiguous()
    cfg_prod = production_eval_cfg(config, cfg)
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    plain = dataclasses.replace(cfg, conv_impl="xla")  # the cuDNN route

    def run(p, c):
        return from_flat(unet.apply_model_flat_io(p, xf, t, c))

    ref = unet.apply_model(params, x, t, plain)
    pp = unet.prepare_params(params, cfg_prod)
    print(f"production, CUDA kernels: {snr_db(run(pp, cfg_prod), ref):.2f} dB")
    p16 = unet.prepare_params(params, cfg16)
    print(f"float taps bf16, CUDA kernels: {snr_db(run(p16, cfg16), ref):.2f} dB")

    for label, group in (
            ("the kernel's group, 8 x 16, halo (1, 1)", None),
            ("the TPU kernel's group, 64 x F, halo (2, 0)",
             ((64, None), (2, 0))),
            ("group 1 x 16, halo (1, 1)", ((1, 16), (1, 1))),
            ("group 2 x 8, halo (1, 1)", ((2, 8), (1, 1)))):
        with twin_route(int8_group=group):
            out = run(pp, cfg_prod)
        print(f"production, plain twins, {label}: {snr_db(out, ref):.2f} dB")

    # weight quantisation alone: the float-tap kernels on the dequantised
    # int8 weights of the int8 stages
    for mod in ("down_modules", "up_modules"):
        for src, dst in zip(pp[mod]["stages"], p16[mod]["stages"]):
            for bsrc, bdst in zip(src["blocks"], dst["blocks"]):
                for name in ("conv1", "conv2"):
                    if "wq" in bsrc[name]:
                        bdst[name]["w"] = (bsrc[name]["wq"].float()
                                           * bsrc[name]["w_scale"])
    print("weight quantisation alone (float taps, bf16 activations): "
          f"{snr_db(run(p16, cfg16), ref):.2f} dB")

    for scale in (0.3, 0.1, 0.0):
        _, _, ps = audio_model(gn3_scale=scale)
        ref_s = unet.apply_model(ps, x, t, plain)
        print(f"final GroupNorm weights x {scale}: production "
              f"{snr_db(run(unet.prepare_params(ps, cfg_prod), cfg_prod), ref_s):.2f}"
              f" dB, float taps bf16 "
              f"{snr_db(run(unet.prepare_params(ps, cfg16), cfg16), ref_s):.2f} dB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
