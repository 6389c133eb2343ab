"""Time the bf16 down conv, the int8-tap conv3x3, the int8-storage conv3x3,
the head and tail convs, the fp32 down, conv3x3 and up convs (training's),
the int8-tap up and down convs and the fp32 weight gradients of the down,
3×3 and up convs of a checkout, on the card, at the audio.yml shapes, B = 1
and 2, against one cuDNN call of the bare conv; for comparing two checkouts
of this package in one machine, in turns.

    python3 -m ddim_audio_tpu_torch.tools.kernel_pair LABEL [KINDS]
    (cd <other checkout> && python3 <this checkout>/ddim_audio_tpu_torch/tools/kernel_pair.py LABEL [KINDS])

KINDS is a comma-separated subset of
down,int8,store,head,tail,down32,upi8,conv32,up32,downi8,downdw32,dw32,updw32,resaff,head32,ftail
(default: all sixteen).
``resaff`` is the int8-storage resblock tail (``residual_affine_flat``) at
s0-s3 in the int8-storage forward's interior mode (int8 x and s with their
scales, the GroupNorm affine, ``quant_out``, statistics; no single PyTorch
call computes it);
``ftail`` the float resblock tail of the sampling forward at its six stages,
B = 8, bf16: ``flat_resblock.resblock_tail`` with the next block's
statistics, against the same call under ``ops.twin_route`` (torch's
passes: addcmul, add, the cast and ``batch_sums``);
``head32`` the fp32 head (2 -> 32, with statistics) at 8192 x 256 against
one fp32 cuDNN call (TF32 off).
``down32`` is the fp32 down conv at the five training transitions of one
microbatch [1, 2, 1024, 256] with statistics, against one fp32 cuDNN call
(TF32 off); ``conv32`` the fp32 conv3x3 at its six stages with every fusion
on (residual, GroupNorm affine + SiLU prologue, add, SiLU, statistics:
chip_smoke.py's ``[train-kernels]`` operands) and ``up32`` the fp32 up conv
at its five transitions with the skip residual and statistics, likewise
against fp32 cuDNN; ``upi8`` the int8-tap up conv in bf16 at
64 -> 32 and 256 -> 192 with the skip residual and statistics, its weights
laid out as ``prepare_params`` gives them (where the checkout's wrapper
takes ``wq_t``); ``downi8`` the int8-tap down conv in bf16 at 32 -> 64 with
statistics, likewise; ``downdw32`` the fp32 down-conv weight gradient
(``conv_down_dw_flat``, its partials' sum included) at the five training
transitions, against one fp32 ``torch.nn.grad.conv2d_weight`` (TF32 off);
``dw32`` the fp32 3×3 weight gradient (``conv_dw_flat``) at the six
training stages and ``updw32`` the fp32 up-conv weight gradient
(``conv_up_dw_flat``) at the five up transitions (x at the lower stage, g
at 2T × 2F), likewise (the up conv's is the weight gradient of the strided
conv that maps g to x).

The package is imported from the current directory, so the same file times
whichever checkout it is run in (one that predates the ``wq_t`` argument of
``conv3x3_flat_int8`` gets the HWIO weights alone). The calls are the
wrappers' own, with the operands of chip_smoke.py's ``[kernels]`` phase:
down with statistics, the int8 taps with every fusion on, with and without
the fused residual, the storage conv in the mode of the int8-storage
forward's interior convs (int8 x with its scales, GroupNorm affine + SiLU
prologue, + add, SiLU, statistics, ``quant_out``) at s0-s3, the head
(2 -> 32, with statistics) and the tail (32 -> 2, with the head skip as its
residual) at 8192 x 256. Times are CUDA-event means over 20 calls after 3
warm-up calls, the card held busy while the host queues them, so that they
are the card's time; the head and tail lines also give the host's time per
wrapper call. Prints one line per shape, then the sums, then the card's
name and power limit.
"""

from __future__ import annotations

import inspect
import os
import subprocess
import sys

DOWNS = [(8192, 256, 32, 64), (4096, 128, 64, 96), (2048, 64, 96, 128),
         (1024, 32, 128, 192), (512, 16, 192, 256)]
# the six stages of a [B, 2, 8192, 256] sampling forward (T, F, C)
SAMPLE_STAGES = [(8192, 256, 32), (4096, 128, 64), (2048, 64, 96),
                 (1024, 32, 128), (512, 16, 192), (256, 8, 256)]
INT8_STAGES = SAMPLE_STAGES[:3]
STORE_STAGES = SAMPLE_STAGES[:4]
HEAD_TAIL = [(8192, 256)]  # the head's input and the tail's output (T, F)
TRAIN_DOWNS = [(1024, 256, 32, 64), (512, 128, 64, 96), (256, 64, 96, 128),
               (128, 32, 128, 192), (64, 16, 192, 256)]
UPS_I8 = [(4096, 128, 64, 32), (256, 8, 256, 192)]
TRAIN_STAGES = [(1024, 256, 32), (512, 128, 64), (256, 64, 96), (128, 32, 128),
                (64, 16, 192), (32, 8, 256)]
TRAIN_UPS = [(t // 2, f // 2, co, ci) for t, f, ci, co in TRAIN_DOWNS]
DOWNS_I8 = [(8192, 256, 32, 64)]
KINDS = ("down", "int8", "store", "head", "tail", "down32", "upi8", "conv32",
         "up32", "downi8", "downdw32", "dw32", "updw32", "resaff", "head32",
         "ftail")


# Cycles the card sleeps before the timed calls (~25-35 ms), so that the
# events time the card alone and not the host's calls (chip_smoke.py).
PREFILL_CYCLES = 50_000_000


def cuda_ms(torch, fn, n: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(PREFILL_CYCLES)  # the host queues the calls meanwhile
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def host_us(torch, fn, n: int = 20) -> float:
    """Host microseconds per call while the card is busy (nothing waits)."""
    import time

    torch.cuda.synchronize()
    torch.cuda._sleep(PREFILL_CYCLES)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    label = argv[0] if argv else "this"
    kinds = set(argv[1].split(",")) if len(argv) > 1 else set(KINDS)
    if not kinds <= set(KINDS):
        print(f"kernel_pair: KINDS is a subset of {','.join(KINDS)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_pair: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.nn.grad import conv2d_weight

    from ddim_audio_tpu_torch.ops import (conv_flat, conv_head_tail,
                                          conv_strided, flat_grad,
                                          flat_resblock, residual_affine,
                                          twin_route)

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=g, device="cuda") * scale

    takes_t = "wq_t" in inspect.signature(
        conv_flat.conv3x3_flat_int8).parameters
    up_takes_t = "wq_t" in inspect.signature(
        conv_strided.conv_up_flat_int8).parameters
    down_takes_t = "wq_t" in inspect.signature(
        conv_strided.conv_down_flat_int8).parameters
    sums: dict = {}

    def add(key, v):
        sums[key] = sums.get(key, 0.0) + v

    for bsz in (1, 2):
        for t, f, ci, co in DOWNS if "down" in kinds else ():
            x = rnd(bsz, t, f * ci).bfloat16()
            w = rnd(4, 4, ci, co, scale=(16 * ci) ** -0.5).bfloat16()
            b = rnd(co)
            k = cuda_ms(torch, lambda: conv_strided.conv_down_flat(
                x, w, b, c_in=ci, c_out=co, want_stats=True))
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: F.conv2d(xn, wl, stride=2, padding=1))
            add(("down", bsz), k)
            add(("down cudnn", bsz), lib)
            print(f"{label} down B{bsz} {ci}->{co} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f}", flush=True)
        for t, f, ci, co in TRAIN_DOWNS if "down32" in kinds else ():
            x = rnd(bsz, t, f * ci)
            w = rnd(4, 4, ci, co, scale=(16 * ci) ** -0.5)
            b = rnd(co)
            k = cuda_ms(torch, lambda: conv_strided.conv_down_flat(
                x, w, b, c_in=ci, c_out=co, want_stats=True))
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: F.conv2d(xn, wl, stride=2, padding=1))
            add(("down32", bsz), k)
            add(("down32 cudnn", bsz), lib)
            print(f"{label} down32 B{bsz} {ci}->{co} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f}", flush=True)
        for t, f, c in TRAIN_STAGES if "conv32" in kinds else ():
            x, res = rnd(bsz, t, f * c), rnd(bsz, t, f * c)
            w = rnd(3, 3, c, c, scale=(9 * c) ** -0.5)
            kw = dict(c=c, residual=res, pre=(1 + 0.1 * rnd(bsz, c),
                                              0.1 * rnd(bsz, c)),
                      add=rnd(bsz, c), pre_silu=True, post_silu=True,
                      want_stats=True)
            k = cuda_ms(torch, lambda: conv_flat.conv3x3_flat(x, w, **kw))
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xn = x.view(bsz, t, f, c).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: F.conv2d(xn, wl, padding=1))
            add(("conv32", bsz), k)
            add(("conv32 cudnn", bsz), lib)
            print(f"{label} conv32 B{bsz} C{c} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f}", flush=True)
        for t, f, ci, co in TRAIN_UPS if "up32" in kinds else ():
            x = rnd(bsz, t, f * ci)
            w = rnd(4, 4, ci, co, scale=(4 * ci) ** -0.5)
            b, res = rnd(co), rnd(bsz, 2 * t, 2 * f * co)
            k = cuda_ms(torch, lambda: conv_strided.conv_up_flat(
                x, w, b, c_in=ci, c_out=co, residual=res, want_stats=True))
            wl = w.permute(2, 3, 0, 1).flip(2, 3).contiguous(
                memory_format=torch.channels_last)
            xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: F.conv_transpose2d(
                xn, wl, stride=2, padding=1))
            add(("up32", bsz), k)
            add(("up32 cudnn", bsz), lib)
            print(f"{label} up32 B{bsz} {ci}->{co} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f}", flush=True)
        for t, f, ci, co in UPS_I8 if "upi8" in kinds else ():
            x = rnd(bsz, t, f * ci).bfloat16()
            w = rnd(4, 4, ci, co, scale=(4 * ci) ** -0.5)
            wq, s_w = conv_strided.quantize_strided_weights_int8(w)
            b, res = rnd(co), rnd(bsz, 2 * t, 2 * f * co).bfloat16()
            extra = ({"wq_t": conv_flat.int8_weights_co_ci(wq)} if up_takes_t
                     else {})
            k = cuda_ms(torch, lambda: conv_strided.conv_up_flat_int8(
                x, wq, s_w, b, c_in=ci, c_out=co, residual=res,
                want_stats=True, **extra))
            wl = w.bfloat16().permute(2, 3, 0, 1).flip(2, 3).contiguous(
                memory_format=torch.channels_last)
            xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: F.conv_transpose2d(
                xn, wl, stride=2, padding=1))
            add(("upi8", bsz), k)
            add(("upi8 cudnn", bsz), lib)
            print(f"{label} upi8 B{bsz} {ci}->{co} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f}", flush=True)
        for t, f, ci, co in DOWNS_I8 if "downi8" in kinds else ():
            x = rnd(bsz, t, f * ci).bfloat16()
            w = rnd(4, 4, ci, co, scale=(16 * ci) ** -0.5)
            wq, s_w = conv_strided.quantize_strided_weights_int8(w)
            b = rnd(co)
            extra = ({"wq_t": conv_flat.int8_weights_co_ci(wq)}
                     if down_takes_t else {})
            k = cuda_ms(torch, lambda: conv_strided.conv_down_flat_int8(
                x, wq, s_w, b, c_in=ci, c_out=co, want_stats=True, **extra))
            wl = w.bfloat16().permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: F.conv2d(xn, wl, stride=2, padding=1))
            add(("downi8", bsz), k)
            add(("downi8 cudnn", bsz), lib)
            print(f"{label} downi8 B{bsz} {ci}->{co} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f}", flush=True)
        for t, f, ci, co in TRAIN_DOWNS if "downdw32" in kinds else ():
            x, gr = rnd(bsz, t, f * ci), rnd(bsz, t // 2, (f // 2) * co)
            k = cuda_ms(torch, lambda: flat_grad.conv_down_dw_flat(
                x, gr, c_in=ci, c_out=co))
            xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
            gn = gr.view(bsz, t // 2, f // 2, co).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: conv2d_weight(
                xn, (co, ci, 4, 4), gn, stride=2, padding=1))
            add(("downdw32", bsz), k)
            add(("downdw32 cudnn", bsz), lib)
            print(f"{label} downdw32 B{bsz} {ci}->{co} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f}", flush=True)
        for t, f, c in TRAIN_STAGES if "dw32" in kinds else ():
            x, gr = rnd(bsz, t, f * c), rnd(bsz, t, f * c)
            k = cuda_ms(torch, lambda: flat_grad.conv_dw_flat(x, gr, c=c))
            xn = x.view(bsz, t, f, c).permute(0, 3, 1, 2)
            gn = gr.view(bsz, t, f, c).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: conv2d_weight(
                xn, (c, c, 3, 3), gn, padding=1))
            add(("dw32", bsz), k)
            add(("dw32 cudnn", bsz), lib)
            print(f"{label} dw32 B{bsz} C{c} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f}", flush=True)
        for t, f, ci, co in TRAIN_UPS if "updw32" in kinds else ():
            x, gr = rnd(bsz, t, f * ci), rnd(bsz, 2 * t, 2 * f * co)
            k = cuda_ms(torch, lambda: flat_grad.conv_up_dw_flat(
                x, gr, c_in=ci, c_out=co))
            xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
            gn = gr.view(bsz, 2 * t, 2 * f, co).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: conv2d_weight(
                gn, (ci, co, 4, 4), xn, stride=2, padding=1))
            add(("updw32", bsz), k)
            add(("updw32 cudnn", bsz), lib)
            print(f"{label} updw32 B{bsz} {ci}->{co} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f}", flush=True)
        for t, f, c in INT8_STAGES if "int8" in kinds else ():
            x, res = rnd(bsz, t, f * c).bfloat16(), rnd(bsz, t, f * c).bfloat16()
            w = rnd(3, 3, c, c, scale=(9 * c) ** -0.5)
            wq, s_w = conv_flat.quantize_conv_weights_int8(w)
            extra = ({"wq_t": conv_flat.int8_weights_co_ci(wq)} if takes_t
                     else {})
            kw = dict(c=c, pre=(1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c)),
                      add=rnd(bsz, c), pre_silu=True, post_silu=True,
                      want_stats=True, **extra)
            k_res = cuda_ms(torch, lambda: conv_flat.conv3x3_flat_int8(
                x, wq, s_w, residual=res, **kw))
            k = cuda_ms(torch, lambda: conv_flat.conv3x3_flat_int8(
                x, wq, s_w, **kw))
            wl = w.bfloat16().permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xn = x.view(bsz, t, f, c).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: F.conv2d(xn, wl, padding=1))
            add(("int8 residual", bsz), k_res)
            add(("int8", bsz), k)
            add(("int8 cudnn", bsz), lib)
            print(f"{label} int8 B{bsz} C{c} kernel(residual) {k_res:.4f} "
                  f"kernel {k:.4f} cudnn {lib:.4f} ratio(residual) "
                  f"{k_res / lib:.2f}", flush=True)
        for t, f, c in STORE_STAGES if "store" in kinds else ():
            x = rnd(bsz, t, f, c)
            q, sc = conv_flat.quantize_store(x)
            w = rnd(3, 3, c, c, scale=(9 * c) ** -0.5).bfloat16()
            kw = dict(c=c, in_scales=sc, pre=(1 + 0.1 * rnd(bsz, c),
                                              0.1 * rnd(bsz, c)),
                      add=rnd(bsz, c), pre_silu=True, post_silu=True,
                      want_stats=True, quant_out=True)
            k = cuda_ms(torch, lambda: conv_flat.conv3x3_flat_store(q, w, **kw))
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xn = x.bfloat16().permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: F.conv2d(xn, wl, padding=1))
            add(("store", bsz), k)
            add(("store cudnn", bsz), lib)
            print(f"{label} store B{bsz} C{c} kernel {k:.4f} cudnn {lib:.4f} "
                  f"ratio {k / lib:.2f}", flush=True)
        for t, f in HEAD_TAIL if kinds & {"head", "tail"} else ():
            # chip_smoke.py's operands: C_in = C_out = 2, C0 = 32
            x = rnd(bsz, t, f * 2).bfloat16()
            wh, bh = rnd(3, 3, 2, 32, scale=0.2).bfloat16(), rnd(32)
            h, res = rnd(bsz, t, f * 32).bfloat16(), rnd(bsz, t, f * 32).bfloat16()
            wt = rnd(3, 3, 32, 2, scale=(9 * 32) ** -0.5).bfloat16()
            bt = rnd(2)
            calls = {
                "head": (lambda: conv_head_tail.conv_head_flat(
                    x, wh, bh, c_in=2, c0=32, want_stats=True),
                    x.view(bsz, t, f, 2), wh),
                "tail": (lambda: conv_head_tail.conv_tail_flat(
                    h, wt, bt, c0=32, c_out=2, residual=res),
                    h.view(bsz, t, f, 32), wt)}
            for kind in sorted(kinds & set(calls)):
                fn, xin, w = calls[kind]
                k = cuda_ms(torch, fn)
                wl = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                xn = xin.permute(0, 3, 1, 2)
                lib = cuda_ms(torch, lambda: F.conv2d(xn, wl, padding=1))
                add((kind, bsz), k)
                add((kind + " cudnn", bsz), lib)
                print(f"{label} {kind} B{bsz} T{t} F{f} kernel {k:.4f} cudnn "
                      f"{lib:.4f} ratio {k / lib:.2f} host "
                      f"{host_us(torch, fn):.1f} us/call", flush=True)
        for t, f, c in STORE_STAGES if "resaff" in kinds else ():
            x = rnd(bsz, t, f, c)
            q, sc = conv_flat.quantize_store(x)
            s8, ssc = conv_flat.quantize_store(rnd(bsz, t, f, c))
            aff = (1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c))
            k = cuda_ms(torch, lambda: residual_affine.residual_affine_flat(
                q, s8, aff, c=c, x_scales=sc, s_scales=ssc, quant_out=True,
                want_stats=True))
            add(("resaff", bsz), k)
            print(f"{label} resaff B{bsz} C{c} kernel {k:.4f}", flush=True)
        for t, f in HEAD_TAIL if "head32" in kinds else ():
            x = rnd(bsz, t, f * 2)
            wh, bh = rnd(3, 3, 2, 32, scale=0.2), rnd(32)
            fn = lambda: conv_head_tail.conv_head_flat(  # noqa: E731
                x, wh, bh, c_in=2, c0=32, want_stats=True)
            k = cuda_ms(torch, fn)
            wl = wh.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xn = x.view(bsz, t, f, 2).permute(0, 3, 1, 2)
            lib = cuda_ms(torch, lambda: F.conv2d(xn, wl, padding=1))
            add(("head32", bsz), k)
            add(("head32 cudnn", bsz), lib)
            print(f"{label} head32 B{bsz} T{t} F{f} kernel {k:.4f} cudnn "
                  f"{lib:.4f} ratio {k / lib:.2f} host "
                  f"{host_us(torch, fn):.1f} us/call", flush=True)
    for t, f, c in SAMPLE_STAGES if "ftail" in kinds else ():
        bsz = 8
        x = rnd(bsz, t, f * c).bfloat16()
        s = (3 * rnd(bsz, t, f * c)).bfloat16()
        scale3, shift3 = 1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c)
        fn = lambda: flat_resblock.resblock_tail(  # noqa: E731
            x, s, scale3, shift3, f=f, c=c, want_stats=True)
        k = cuda_ms(torch, fn)
        with twin_route():
            tw = cuda_ms(torch, fn)
        add(("ftail", bsz), k)
        add(("ftail twin", bsz), tw)
        print(f"{label} ftail B{bsz} T{t} F{f} C{c} kernel {k:.4f} twin "
              f"{tw:.4f} ratio {k / tw:.2f}", flush=True)
        del x, s
    for (name, bsz), v in sorted(sums.items()):
        print(f"{label} sum {name} B{bsz} {v:.4f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(label, smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
