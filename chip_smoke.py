#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``ddim_audio_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ddim_audio_tpu_torch/csrc``
with nvcc (sm_90a; one nvcc per source, started together) and runs, each
phase on its own lines:

1. device: requires CUDA, prints the card's name and power limit, turns TF32
   off for the plain references;
2. build: compiles the kernels and prints the build seconds;
3. kernels vs their plain PyTorch twins at every production stage shape, in
   fp32 and bf16, at B = 1 (the batch of the forwards and chains below) and
   at B = 2 (the batch the command line gives them: ``sampling.num_samples``
   of audio.yml): conv3x3 (float taps, and int8 taps at the three stages that
   run them, against the twin with the kernel's own quantisation group), the
   down and up transitions, the head and the tail (also at one small ragged
   shape). Each bf16 case prints the kernel's and the twin's time from CUDA
   events, its bound (the larger of bytes moved / 3.35 TB/s and operations /
   the peak rate of the operand type) and the time of the one PyTorch call
   that computes the bare conv (bf16, channels-last, cuDNN);
4. full-width forward of the audio.yml model (47,155,266 params, seed-made
   weights with non-zero final GroupNorm weights) at [1, 2, 8192, 256]: the
   production forward (bf16, int8 taps, as audio.yml ships it) and the
   float-tap fp32 and bf16 forwards against the fp32 plain route, with the
   launch counts of one forward each, and their times. Both bf16 forwards
   also run through the plain twins (``ops.twin_route``) with every wrapper
   call shadowed by its kernel on the same operands, which holds each kernel
   against its twin on the model's own activations and tells a kernel fault
   from int8 arithmetic noise; then route is held against route;
5. the slice, through the command line's ``main([...])`` in-process, on a
   checkpoint of those weights, audio.yml unmodified (2 clips per run): DDIM
   last-only (10 steps), ``--sequence 3`` (6 steps) and ``--sample_type
   ddpm_noisy --sequence 2`` (6 steps), with the launch counts of these runs
   and the files written, every exported array finite; the last-only run
   again through the runner, whose WAVs must equal the command line's and
   whose two clips are held against the same run through the plain twins
   from the same noise, every wrapper call of that run shadowed at B = 2;
   one ``--sequence -1`` run through the runner with
   the kept-state budget lowered, so that buffers drain mid-run;
6. the float-tap path: the runner's ``sample_last_only`` with
   ``sampling.tap_int8`` off (2 clips, 4 steps) with its own launch counts,
   then 4-step chains, bf16 kernels (float taps and production) against the
   fp32 plain chain from the same x_T, on init weights and on the
   non-zero-GN3 weights.

Every failure raises and the script exits non-zero. The last three lines are
the card, the per-kernel JSON summary and ``{"ok": true, "device": {...}}``.
In the summary ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are sums
over the kernel's production shapes in bf16 at B = 2, each shape once;
``launches`` counts the launches of the three command-line runs of phase 5. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Stated tolerances (relative = max|kernel − twin| / max|twin|).
TOL_FP32 = 1e-4
TOL_BF16 = 2e-2
TOL_STATS = 1e-3
# int8 taps vs the twin with the kernel's own group: the integers agree except
# where the kernel's fused multiply-add in the prologue moves a value across a
# quantisation boundary, so the output is held to an SNR and the statistics
# to 1e-4 relative.
SNR_INT8_KERNEL_DB = 78.0  # an H100 read 80.6 dB at the worst case (bf16, C 96)
TOL_INT8_STATS = 1e-4
SNR_FWD_FP32_DB = 90.0
SNR_FWD_BF16_DB = 38.0
# The production forward (bf16, int8 taps at C <= 96) against the fp32 plain
# route. On init weights (GN3 = 0, the JAX package's own guard setting) every
# resblock branch is multiplied by zero, so the int8 taps cannot show: an H100
# read 47.91 dB, the same as float taps. On the non-zero-GN3 weights (final
# GroupNorm weights 1 ± 0.2, every branch as strong as its skip) the int8
# noise of all 28 convs reaches the output: an H100 read 27.31 dB, the plain
# twins 27.31 dB, the twins with the TPU kernel's coarser quantisation group
# 24.27 dB, and weight quantisation alone 36.77 dB, so that reading is what
# this arithmetic gives on these weights, not a fault of the kernels (PERF.md).
SNR_FWD_PROD_INIT_DB = 45.9
SNR_FWD_PROD_GN3_DB = 25.3
# The guards that tell a kernel fault from that noise. The forward runs
# through the plain twins (``ops.twin_route``) and every wrapper call of it
# also launches its kernel on the same operands (the route's ``shadow``), so
# each kernel is held against its twin on the activations the model really
# gives it, call by call. An H100 read, as the worst call of the bf16
# forwards at B = 1 and of a 10-step chain at B = 2: conv3x3 float 67.3 dB,
# int8 68.4 dB (79.6 dB in the forward), down 79.8, up 89.1, tail 92.1, head
# 106.0 dB; statistics within 2.3e-5 relative.
SHADOW_FLOAT_DB = 65.3
SHADOW_INT8_DB = 66.4
SHADOW_STATS = 1e-4
# Then the forward through the kernels against the forward through the
# twins, same weights. These weights amplify a last-bit difference to about
# -45 dB by the end of a forward, so the routes agree far less than the calls
# do: an H100 read 42.82 dB (float taps) and 31.48 dB (production).
SNR_FWD_FLOAT_TWIN_DB = 40.8
SNR_FWD_PROD_TWIN_DB = 29.4
# The command line's 10-step last-only run at B = 2, kernels against twins
# from the same noise, each clip on its own: an H100 read 33.38 / 30.98 dB.
SNR_SLICE_TWIN_DB = 28.9
# 4-step chains against the fp32 plain chain. Float taps: the JAX package's
# own chain guard on init weights (an H100 read 49.62 dB at 4 steps), and on
# the non-zero-GN3 weights a floor between the kernel chain (42.46 dB) and
# the plain bf16 chain (38.83 dB), so a kernel fault of a few dB fails it.
SNR_CHAIN_BF16_DB = 44.0
SNR_CHAIN_GN3_BF16_DB = 41.0
# production chains: an H100 read 49.62 dB (init weights) and 30.84 dB
SNR_CHAIN_PROD_INIT_DB = 47.6
SNR_CHAIN_PROD_GN3_DB = 28.8
PARAMS_AUDIO_YML = 47_155_266

# Published H100 SXM peaks: HBM bytes/s and dense operations/s by operand type
# (fp32 outside the tensor cores).
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}

# Production stage shapes at [1, 2, 8192, 256] (T, F, C), and transitions
# (T_in, F_in, C_in, C_out) of the down path.
STAGES = [(8192, 256, 32), (4096, 128, 64), (2048, 64, 96), (1024, 32, 128),
          (512, 16, 192), (256, 8, 256)]
INT8_STAGES = STAGES[:3]
DOWNS = [(8192, 256, 32, 64), (4096, 128, 64, 96), (2048, 64, 96, 128),
         (1024, 32, 128, 192), (512, 16, 192, 256)]
HEAD_TAIL = [(8192, 256, True), (40, 24, False)]  # (T, F, production shape)

CSRC = "ddim_audio_tpu_torch/csrc/"
PALLAS = "ddim_audio_tpu/ops/pallas/"
REPLACES = {
    "conv3x3_flat": (CSRC + "conv3x3.cu", PALLAS + "conv_flat.py:235"),
    "conv3x3_flat_int8": (CSRC + "conv3x3_int8.cu", PALLAS + "conv_flat.py:334"),
    "conv_down_flat": (CSRC + "conv_strided.cu", PALLAS + "conv_strided.py:182"),
    "conv_up_flat": (CSRC + "conv_strided.cu", PALLAS + "conv_strided.py:512"),
    "conv_head_flat": (CSRC + "conv_head_tail.cu",
                       PALLAS + "conv_head_tail.py:126"),
    "conv_tail_flat": (CSRC + "conv_head_tail.cu",
                       PALLAS + "conv_head_tail.py:302"),
}
# launches of one forward: float-tap route and production route
PER_FORWARD_FLOAT = {"conv3x3_flat": 64, "conv3x3_flat_int8": 0,
                     "conv_head_flat": 1, "conv_tail_flat": 1,
                     "conv_down_flat": 5, "conv_up_flat": 5}
PER_FORWARD_PROD = dict(PER_FORWARD_FLOAT, conv3x3_flat=36,
                        conv3x3_flat_int8=28)


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


@contextlib.contextmanager
def reference_route(**kw):
    """``ops.twin_route`` with cuDNN held to its deterministic algorithms. The
    twins' fp32 transposed conv otherwise differs in the last bit from run to
    run, and on these weights the rest of the forward amplifies that to
    -45 dB (an H100 read 44.7 dB between two runs of the float-tap twin
    route), which would make every floor below a matter of luck. The
    kernels are deterministic as they are."""
    import torch

    from ddim_audio_tpu_torch.ops import twin_route

    old, torch.backends.cudnn.deterministic = \
        torch.backends.cudnn.deterministic, True
    try:
        with twin_route(**kw):
            yield
    finally:
        torch.backends.cudnn.deterministic = old


class Shadow:
    """``twin_route``'s shadow: per kernel, the calls seen and the worst
    agreement of a kernel's output and statistics with its twin's on the
    same operands."""

    def __init__(self):
        self.seen = {}

    def __call__(self, name, outs, refs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        srel = max([rel_err(o, r)[1] for o, r in zip(outs[1:], refs[1:])],
                   default=0.0)
        entry = self.seen.setdefault(name, [0, math.inf, 0.0])
        entry[0] += 1
        entry[1] = min(entry[1], snr_db(outs[0], refs[0]))
        entry[2] = max(entry[2], srel)

    def check(self, tag, want_calls):
        calls = {name: e[0] for name, e in self.seen.items()}
        want_calls = {k: v for k, v in want_calls.items() if v}
        require(calls == want_calls, f"{tag}: shadowed calls {calls} != "
                f"{want_calls}")
        for name, (n, snr, srel) in self.seen.items():
            floor = SHADOW_INT8_DB if name.endswith("int8") else SHADOW_FLOAT_DB
            log(f"{tag} {name}: {n} calls on the model's own activations, "
                f"worst SNR vs the twin {snr:.1f} dB (>= {floor}), worst "
                f"stats rel {srel:.2e} (<= {SHADOW_STATS})")
            require(snr >= floor, f"{tag} {name}: SNR {snr:.2f} < {floor} dB")
            require(srel <= SHADOW_STATS, f"{tag} {name}: stats rel {srel:.2e}")


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


def bound_ms(tensors, ops: float, kind: str) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes of
    ``tensors`` (every input read once, every output written once) over the
    memory rate and ``ops`` over the peak rate of operand type ``kind``."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nchw(x, c):
    """Flat [B, T, F·C] → the channels-last NCHW view cuDNN takes."""
    b, t, fc = x.shape
    return x.view(b, t, fc // c, c).permute(0, 3, 1, 2)


def _oihw(w):
    import torch

    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _kernel_cases(torch, bsz):
    """One dict per case at batch bsz with every fusion of the main path on:
    name, label, prod (a production shape: timed and summed), kernel, twin,
    make(dtype) -> (args, kwargs), lib(args, kwargs) -> the one-PyTorch-call
    conv on the same operands, io(args, kwargs, outs) -> the tensors the
    function must move, ops (operations of the taps), int8."""
    import torch.nn.functional as F

    from ddim_audio_tpu_torch.ops.conv_flat import (
        INT8_KERNEL_HALO, INT8_KERNEL_TILE, conv3x3_flat, conv3x3_flat_int8,
        conv3x3_flat_int8_plain, conv3x3_flat_plain,
        quantize_conv_weights_int8)
    from ddim_audio_tpu_torch.ops.conv_head_tail import (
        conv_head_flat, conv_head_flat_plain, conv_tail_flat,
        conv_tail_flat_plain)
    from ddim_audio_tpu_torch.ops.conv_strided import (
        conv_down_flat, conv_down_flat_plain, conv_up_flat,
        conv_up_flat_plain, up_weight_to_torch)

    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def io_conv(pos, kw, outs):
        return [*pos, kw.get("residual"), *(kw.get("pre") or ()),
                kw.get("add"), *outs]

    cases = []
    for t, f, c in STAGES:
        x, w, res = rnd(bsz, t, f * c), rnd(3, 3, c, c, scale=(9 * c) ** -0.5), \
            rnd(bsz, t, f * c)
        pre, add = (1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c)), rnd(bsz, c)
        fused = dict(c=c, pre=pre, add=add, pre_silu=True, post_silu=True,
                     want_stats=True)

        def make(dt, x=x, w=w, res=res, fused=fused):
            return (x.to(dt), w.to(dt)), dict(fused, residual=res.to(dt))

        def lib(pos, kw, w=w, c=c):
            wl = _oihw(w.to(pos[0].dtype))
            return lambda: F.conv2d(_nchw(pos[0], c), wl, padding=1)
        ops = 2.0 * 9 * c * c * t * f * bsz
        cases.append(dict(name="conv3x3_flat", label=f"T{t} F{f} C{c}",
                          prod=True, kernel=conv3x3_flat,
                          twin=conv3x3_flat_plain, make=make, lib=lib,
                          io=io_conv, ops=ops, int8=False))
        if (t, f, c) not in INT8_STAGES:
            continue
        wq, s_w = quantize_conv_weights_int8(w)

        def make8(dt, x=x, wq=wq, s_w=s_w, res=res, fused=fused):
            return (x.to(dt), wq, s_w), dict(fused, residual=res.to(dt))

        def twin8(*pos, **kw):  # the kernel's own quantisation group
            return conv3x3_flat_int8_plain(
                *pos, q_tile=INT8_KERNEL_TILE, q_halo=INT8_KERNEL_HALO, **kw)
        cases.append(dict(name="conv3x3_flat_int8", label=f"T{t} F{f} C{c}",
                          prod=True, kernel=conv3x3_flat_int8, twin=twin8,
                          make=make8, lib=lib, io=io_conv, ops=ops, int8=True))
    for t, f, ci, co in DOWNS:
        x, w, b = (rnd(bsz, t, f * ci), rnd(4, 4, ci, co, scale=(16 * ci) ** -0.5),
                   rnd(co))

        def make(dt, x=x, w=w, b=b, ci=ci, co=co):
            return (x.to(dt), w.to(dt), b), dict(c_in=ci, c_out=co,
                                                 want_stats=True)

        def lib(pos, kw, w=w, ci=ci):
            wl = _oihw(w.to(pos[0].dtype))
            return lambda: F.conv2d(_nchw(pos[0], ci), wl, stride=2, padding=1)
        cases.append(dict(name="conv_down_flat", label=f"T{t} F{f} {ci}->{co}",
                          prod=True, kernel=conv_down_flat,
                          twin=conv_down_flat_plain, make=make, lib=lib,
                          io=io_conv, ops=2.0 * 16 * ci * co * (t // 2) * (f // 2) * bsz,
                          int8=False))
    for t, f, co, ci in DOWNS:  # up runs each transition in reverse
        x, w, b, res = (rnd(bsz, t // 2, (f // 2) * ci),
                        rnd(4, 4, ci, co, scale=(4 * ci) ** -0.5), rnd(co),
                        rnd(bsz, t, f * co))

        def make(dt, x=x, w=w, b=b, res=res, ci=ci, co=co):
            return (x.to(dt), w.to(dt), b), dict(
                c_in=ci, c_out=co, residual=res.to(dt), want_stats=True)

        def lib(pos, kw, w=w, ci=ci):
            wl = up_weight_to_torch(w.to(pos[0].dtype)).contiguous(
                memory_format=torch.channels_last)
            return lambda: F.conv_transpose2d(_nchw(pos[0], ci), wl, stride=2,
                                              padding=1)
        cases.append(dict(name="conv_up_flat",
                          label=f"T{t // 2} F{f // 2} {ci}->{co}", prod=True,
                          kernel=conv_up_flat, twin=conv_up_flat_plain,
                          make=make, lib=lib, io=io_conv,
                          ops=2.0 * 4 * ci * co * t * f * bsz, int8=False))
    for t, f, prod in HEAD_TAIL:
        cin, c0 = 2, 32
        x, wh, bh = rnd(bsz, t, f * cin), rnd(3, 3, cin, c0, scale=0.2), rnd(c0)
        h, res = rnd(bsz, t, f * c0), rnd(bsz, t, f * c0)
        wt, bt = rnd(3, 3, c0, cin, scale=(9 * c0) ** -0.5), rnd(cin)

        def make_h(dt, x=x, wh=wh, bh=bh):
            return (x.to(dt), wh.to(dt), bh), dict(c_in=2, c0=32,
                                                   want_stats=True)

        def lib_h(pos, kw, wh=wh):
            wl = _oihw(wh.to(pos[0].dtype))
            return lambda: F.conv2d(_nchw(pos[0], 2), wl, padding=1)

        def make_t(dt, h=h, res=res, wt=wt, bt=bt):
            return (h.to(dt), wt.to(dt), bt), dict(c0=32, c_out=2,
                                                   residual=res.to(dt))

        def lib_t(pos, kw, wt=wt):
            wl = _oihw(wt.to(pos[0].dtype))
            return lambda: F.conv2d(_nchw(pos[0], 32), wl, padding=1)
        ops = 2.0 * 9 * cin * c0 * t * f * bsz
        cases.append(dict(name="conv_head_flat", label=f"T{t} F{f} 2->32",
                          prod=prod, kernel=conv_head_flat,
                          twin=conv_head_flat_plain, make=make_h, lib=lib_h,
                          io=io_conv, ops=ops, int8=False))
        cases.append(dict(name="conv_tail_flat", label=f"T{t} F{f} 32->2",
                          prod=prod, kernel=conv_tail_flat,
                          twin=conv_tail_flat_plain, make=make_t, lib=lib_t,
                          io=io_conv, ops=ops, int8=False))
    return cases


def phase_kernels(summary):
    import torch

    def as_tuple(r):
        return r if isinstance(r, tuple) else (r,)

    for bsz in (1, 2):
        for case in _kernel_cases(torch, bsz):
            name, label, kern, twin = (case["name"], f"B{bsz} " + case["label"],
                                       case["kernel"], case["twin"])
            for dtype, tol, dt in ((torch.float32, TOL_FP32, "fp32"),
                                   (torch.bfloat16, TOL_BF16, "bf16")):
                pos, kw = case["make"](dtype)
                outs = as_tuple(kern(*pos, **kw))
                refs = as_tuple(twin(*pos, **kw))
                torch.cuda.synchronize()
                err, rel = rel_err(outs[0], refs[0])
                line = (f"[kernels] {name:17s} {label:23s} {dt} max_abs "
                        f"{err:.3e} rel {rel:.3e}")
                if case["int8"]:
                    snr = snr_db(outs[0], refs[0])
                    line += f" SNR {snr:.1f} dB (>= {SNR_INT8_KERNEL_DB})"
                    require(snr >= SNR_INT8_KERNEL_DB, f"{name} {label} {dt}: SNR "
                            f"{snr:.2f} < {SNR_INT8_KERNEL_DB} dB vs the twin")
                else:
                    require(rel <= tol, f"{name} {label} {dt}: rel err {rel:.3e} "
                            f"> {tol}")
                if len(outs) == 3:
                    srel = max(rel_err(outs[1], refs[1])[1],
                               rel_err(outs[2], refs[2])[1])
                    stol = TOL_INT8_STATS if case["int8"] else TOL_STATS
                    line += f" stats rel {srel:.3e} (<= {stol})"
                    require(srel <= stol, f"{name} {label} {dt}: stats rel err "
                            f"{srel:.3e} > {stol}")
                entry = summary.setdefault(name, {
                    "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                    "bound_ms": 0.0, "library_ms": 0.0, "_bytes": 0.0, "_ops": 0.0})
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                if not case["prod"]:
                    log(line)
                    continue
                ms = cuda_time(lambda: kern(*pos, **kw))
                plain_ms = cuda_time(lambda: twin(*pos, **kw), n=5, warmup=1)
                kind = "int8" if case["int8"] else dt
                bnd, by = bound_ms(case["io"](pos, kw, outs), case["ops"], kind)
                line += (f" | kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, bound "
                         f"{bnd:.3f} ms ({by})")
                if dtype == torch.bfloat16:
                    lib_ms = cuda_time(case["lib"](pos, kw))
                    line += f", cuDNN bf16 conv {lib_ms:.3f} ms"
                if dtype == torch.bfloat16 and bsz == 2:  # the main path
                    entry["ms"] += ms
                    entry["plain_ms"] += plain_ms
                    entry["bound_ms"] += bnd
                    entry["library_ms"] += lib_ms
                    entry["_bytes" if by == "bytes" else "_ops"] += bnd
                log(line)
    for entry in summary.values():
        entry["bound_by"] = ("bytes" if entry.pop("_bytes") >= entry.pop("_ops")
                             else "operations")


def _audio_params():
    """audio.yml config (fp32 compute) and seed-made weights with non-zero
    final GroupNorm weights (zero-init GN3 makes every resblock the identity
    and would hide conv errors)."""
    from ddim_audio_tpu_torch.models.unet import count_params
    from ddim_audio_tpu_torch.tools import audio_model

    config, cfg, params = audio_model()
    n = count_params(params)
    require(n == PARAMS_AUDIO_YML, f"param count {n} != {PARAMS_AUDIO_YML}")
    return config, cfg, params


def phase_forward(config, cfg, params):
    import dataclasses

    import torch

    from ddim_audio_tpu_torch.config import production_eval_cfg
    from ddim_audio_tpu_torch.models.unet import (apply_model,
                                                  apply_model_flat_io,
                                                  flat_io_adapters, init_model,
                                                  prepare_params)
    from ddim_audio_tpu_torch.ops import launch_counts, reset_launch_counts
    from ddim_audio_tpu_torch.tools import forward_input

    x, t = forward_input(cfg)
    to_flat, from_flat = flat_io_adapters(cfg)
    xf = to_flat(x).contiguous()
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    cfg_prod = production_eval_cfg(config, cfg)  # audio.yml as it ships
    require(cfg_prod.dtype == torch.bfloat16 and cfg_prod.tap_int8,
            f"production eval config is not bf16 + tap_int8: {cfg_prod}")
    log(f"[forward] audio.yml, {PARAMS_AUDIO_YML} params, x [1, 2, 8192, 256], "
        "t [500], non-zero GN3 weights")

    # bf16 runs take the weights prepared once, as the runner passes them
    p16 = prepare_params(params, cfg16)
    p_prod = prepare_params(params, cfg_prod)
    ref = apply_model(params, x, t, cfg)
    outs = {}
    for name, c, p, thresh, want in (
            ("float taps fp32", cfg, params, SNR_FWD_FP32_DB, PER_FORWARD_FLOAT),
            ("float taps bf16", cfg16, p16, SNR_FWD_BF16_DB, PER_FORWARD_FLOAT),
            ("production (bf16, int8 taps)", cfg_prod, p_prod,
             SNR_FWD_PROD_GN3_DB, PER_FORWARD_PROD)):
        reset_launch_counts()
        out = from_flat(apply_model_flat_io(p, xf, t, c))
        torch.cuda.synchronize()
        counts = launch_counts()
        require(bool(torch.isfinite(out).all()), f"{name} forward not finite")
        snr = snr_db(out, ref)
        log(f"[forward] kernel route, {name}, vs fp32 plain: SNR {snr:.2f} dB "
            f"(>= {thresh}) | launches {counts}")
        require(snr >= thresh, f"{name} forward SNR {snr:.2f} < {thresh} dB")
        require(counts == want, f"launches per forward {counts} != {want}")
        outs[name] = out
    for name, c, p, floor, want in (
            ("float taps bf16", cfg16, p16, SNR_FWD_FLOAT_TWIN_DB,
             PER_FORWARD_FLOAT),
            ("production (bf16, int8 taps)", cfg_prod, p_prod,
             SNR_FWD_PROD_TWIN_DB, PER_FORWARD_PROD)):
        shadow = Shadow()
        with reference_route(shadow=shadow):
            twin = from_flat(apply_model_flat_io(p, xf, t, c))
        shadow.check(f"[forward] {name}, B1,", want)
        reset_launch_counts()
        with reference_route():
            again = from_flat(apply_model_flat_io(p, xf, t, c))
        require(not any(launch_counts().values()),
                f"the twin route launched kernels: {launch_counts()}")
        require(bool(torch.equal(twin, again)),
                "the shadow changed the twin route's result")
        snr = snr_db(outs[name], twin)
        log(f"[forward] kernel route, {name}, vs the same forward through the "
            f"plain twins: SNR {snr:.2f} dB (>= {floor}); twins vs fp32 plain "
            f"{snr_db(twin, ref):.2f} dB")
        require(snr >= floor, f"{name} forward vs its twin route: SNR "
                f"{snr:.2f} < {floor} dB")
    del twin, again, outs
    ref16 = apply_model(p16, x, t, cfg16)
    log(f"[forward] plain route bf16 vs fp32 plain: SNR "
        f"{snr_db(ref16, ref):.2f} dB (for comparison)")
    p0 = init_model(torch.Generator().manual_seed(0), cfg)
    ref0 = apply_model(p0, x, t, cfg)
    out0 = from_flat(apply_model_flat_io(prepare_params(p0, cfg_prod), xf, t,
                                         cfg_prod))
    snr0 = snr_db(out0, ref0)
    log(f"[forward] kernel route, production, init weights (GN3 = 0), vs fp32 "
        f"plain: SNR {snr0:.2f} dB (>= {SNR_FWD_PROD_INIT_DB})")
    require(snr0 >= SNR_FWD_PROD_INIT_DB, f"production forward on init "
            f"weights: SNR {snr0:.2f} < {SNR_FWD_PROD_INIT_DB} dB")
    del p0, ref0, out0
    times = {
        "kernel route, production": lambda: apply_model_flat_io(p_prod, xf, t,
                                                                cfg_prod),
        "kernel route, float taps bf16": lambda: apply_model_flat_io(p16, xf, t,
                                                                     cfg16),
        "plain route bf16 (cuDNN)": lambda: apply_model(p16, x, t, cfg16),
        "kernel route, float taps fp32": lambda: apply_model_flat_io(params, xf,
                                                                     t, cfg),
        "plain route fp32 (cuDNN)": lambda: apply_model(params, x, t, cfg),
    }
    for rnd in (1, 2):  # in turns, twice: the routes are compared within a run
        for label, fn in times.items():
            log(f"[forward] round {rnd}, {label}: "
                f"{cuda_time(fn, n=5, warmup=1):.2f} ms / forward")


def _read_wav(path):
    from scipy.io.wavfile import read

    return read(path)[1].astype(np.float64)


def _count_files(folder, want):
    got = sorted(os.listdir(folder))
    require(got == sorted(want), f"{folder}: files {got} != {sorted(want)}")
    for name in got:
        require(os.path.getsize(os.path.join(folder, name)) > 0,
                f"{folder}/{name} is empty")


def phase_slice(summary, params):
    """This slice's main path: the command line → Diffusion.sample → the
    sampler driver → the production-config denoiser, audio.yml unmodified."""
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion

    runs = [  # (label, steps, extra flags, files per clip)
        ("DDIM last-only", 10, [], ["{j}_final"]),
        ("DDIM --sequence 3", 6, ["--sequence", "3"],
         ["{j}_0", "{j}_1", "{j}_2"]),
        ("DDPM --sequence 2", 6, ["--sequence", "2", "--sample_type",
                                  "ddpm_noisy"], ["{j}_0", "{j}_1"]),
    ]
    clips = 2  # sampling.num_samples of audio.yml
    seed = 1234  # the command line's default

    # every array a run exports is looked at before it is written: a
    # non-finite one fails the run (the command line then exits 1)
    exported = []
    export = Diffusion.export

    def checked_export(self, out, names):
        require(out.shape == (clips, 2, 8192, 256),
                f"exported array of shape {out.shape}")
        require(bool(np.isfinite(out).all()),
                f"non-finite output in {list(names)}")
        exported.append(list(names))
        return export(self, out, names)

    Diffusion.export = checked_export
    try:
        _phase_slice(summary, params, runs, clips, seed, exported)
    finally:
        Diffusion.export = export


def _phase_slice(summary, params, runs, clips, seed, exported):
    import logging
    from types import SimpleNamespace

    import torch

    from ddim_audio_tpu_torch import cli
    from ddim_audio_tpu_torch.config import load_config
    from ddim_audio_tpu_torch.diffusion.schedules import \
        make_timestep_subsequence
    from ddim_audio_tpu_torch.ops import launch_counts, reset_launch_counts
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
    from ddim_audio_tpu_torch.sampling import driver
    from ddim_audio_tpu_torch.weights import save_eval_checkpoint

    with tempfile.TemporaryDirectory() as exp:
        t0 = time.perf_counter()
        save_eval_checkpoint(os.path.join(exp, "logs", "smoke"), params)
        log(f"[slice] wrote the seed-made weights as logs/smoke/ckpt.npz in "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        reset_launch_counts()
        forwards = 0
        for k, (label, steps, flags, names) in enumerate(runs):
            t0 = time.perf_counter()
            try:
                code = cli.main(["--config", "audio.yml", "--doc", "smoke",
                                 "--exp", exp, "--ni", "--sample", "--verbose",
                                 "warning", "--timesteps", str(steps), "-i",
                                 f"run{k}", *flags])
            finally:
                logging.getLogger().handlers.clear()
            wall = time.perf_counter() - t0
            require(code == 0, f"CLI run '{label}' exited {code}")
            require(len(exported) == len(names), f"CLI run '{label}' exported "
                    f"{len(exported)} arrays, expected {len(names)}")
            exported.clear()
            _count_files(os.path.join(exp, "image_samples", f"run{k}"),
                         [n.format(j=j) + ext for j in range(clips)
                          for n in names for ext in (".png", ".wav")])
            # the uniform grid of 1000 // steps may overshoot the request
            forwards += len(make_timestep_subsequence(1000, steps, "uniform"))
            log(f"[slice] CLI {label}, --timesteps {steps}, {clips} clips "
                f"[2, 2, 8192, 256]: exit 0, {len(names) * clips * 2} files, "
                f"every exported array finite, host wall {wall:.2f} s (checkpoint load, denoise, export "
                "included)")
        counts = launch_counts()
        want = {k: v * forwards for k, v in PER_FORWARD_PROD.items()}
        log(f"[slice] launches of the three CLI runs ({forwards} forwards): "
            f"{counts}")
        require(counts == want, f"main-path launches {counts} != {want}")
        for name, n in counts.items():
            require(n > 0, f"{name} was never launched on the main path")
            summary[name]["launches"] = n

        # The last-only run again through the runner, from the same seed:
        # its WAVs are the command line's, and its two clips are held against
        # the same run through the plain twins from the same noise.
        config = load_config("configs/audio.yml")
        steps = runs[0][1]
        outs = {}
        for route in ("kernels", "twins"):
            args = SimpleNamespace(
                seed=seed, timesteps=steps, skip_type="uniform", eta=0.0,
                sample_type="generalized",
                image_folder=os.path.join(exp, "image_samples", route))
            shadow = Shadow()
            t0 = time.perf_counter()
            with reference_route(force=route == "twins", shadow=shadow):
                outs[route] = Diffusion(args, config).sample_last_only(params)
            log(f"[slice] runner last-only through the {route}, {steps} steps, "
                f"{clips} clips: host wall {time.perf_counter() - t0:.2f} s")
            if route == "twins":
                shadow.check("[slice] B2,", {k: v * steps for k, v in
                                             PER_FORWARD_PROD.items()})
        for j in range(clips):
            wav = [_read_wav(os.path.join(exp, "image_samples", d,
                                          f"{j}_final.wav"))
                   for d in ("run0", "kernels")]
            same = bool(np.array_equal(wav[0], wav[1]))
            snr = snr_db(torch.from_numpy(outs["kernels"][j]),
                         torch.from_numpy(outs["twins"][j]))
            log(f"[slice] clip {j}: the runner's WAV equals the command "
                f"line's: {same}; kernels vs twins, {steps}-step sample: SNR "
                f"{snr:.2f} dB (>= {SNR_SLICE_TWIN_DB})")
            require(float(np.abs(wav[0]).max()) > 0, f"clip {j}: silent WAV")
            require(same, f"clip {j}: the runner's WAV differs from the "
                    "command line's from the same seed")
            require(snr >= SNR_SLICE_TWIN_DB, f"clip {j}: kernels vs twins "
                    f"SNR {snr:.2f} < {SNR_SLICE_TWIN_DB} dB")
        exported.clear()

        # --sequence -1 keeps every step; with the budget under two buffer
        # pairs the pending buffers must leave the device mid-run
        args = SimpleNamespace(
            seed=3, timesteps=4, skip_type="uniform", eta=0.0,
            sample_type="generalized", sequence=-1,
            log_path=os.path.join(exp, "logs", "smoke"),
            image_folder=os.path.join(exp, "image_samples", "drain"))
        pair = 2 * clips * 2 * 8192 * 256 * 2  # x0 + xt, fp16
        budget, driver._BUFFER_BUDGET_BYTES = driver._BUFFER_BUDGET_BYTES, \
            pair + pair // 2
        try:
            runner = Diffusion(args, config)
            runner.sample()
        finally:
            driver._BUFFER_BUDGET_BYTES = budget
        tm = runner.timings
        log(f"[slice] --sequence -1, 4 steps, budget {pair + pair // 2} bytes: "
            f"mid_drains {tm['mid_drains']}, compute {tm['compute_s']:.2f} s, "
            f"drain {tm['drain_s']:.2f} s")
        require(tm["mid_drains"] > 0, "no mid-run drain with a lowered budget")
        _count_files(args.image_folder,
                     [f"{j}_{i}{ext}" for j in range(clips) for i in range(4)
                      for ext in (".png", ".wav")])


def phase_float_path(summary, config, cfg, params):
    """The float-tap path (``sampling.tap_int8`` off): the runner's
    sample_last_only, and the chain guards."""
    import dataclasses
    from types import SimpleNamespace

    import torch

    from ddim_audio_tpu_torch.diffusion.schedules import \
        make_timestep_subsequence
    from ddim_audio_tpu_torch.models.unet import (apply_model,
                                                  apply_model_flat_io,
                                                  flat_io_adapters, init_model,
                                                  prepare_params)
    from ddim_audio_tpu_torch.ops import launch_counts, reset_launch_counts
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
    from ddim_audio_tpu_torch.sampling.driver import ScanSampler

    steps, clips = 4, 2
    log(f"[float] override: sampling.tap_int8 {config.sampling.tap_int8} -> "
        f"False; sampling.num_samples {config.sampling.num_samples} -> 1 "
        f"(clips run one at a time); sampling.dtype {config.sampling.dtype}")
    cfg_prod = Diffusion(SimpleNamespace(seed=0), config).eval_cfg
    config.sampling.tap_int8 = False
    config.sampling.num_samples = 1

    def args_for(seed, folder):
        return SimpleNamespace(seed=seed, timesteps=steps, skip_type="uniform",
                               eta=0.0, sample_type="generalized",
                               image_folder=folder)

    with tempfile.TemporaryDirectory() as tmp:
        runners = [Diffusion(args_for(k, os.path.join(tmp, f"clip{k}")), config)
                   for k in range(clips)]
        require(runners[0].eval_cfg.dtype == torch.bfloat16
                and not runners[0].eval_cfg.tap_int8,
                "eval config is not bf16 with float taps")
        walls = []
        torch.cuda.synchronize()
        reset_launch_counts()
        for runner in runners:
            t0 = time.perf_counter()
            out = runner.sample_last_only(params)
            walls.append(time.perf_counter() - t0)
            require(out.shape == (1, 2, 8192, 256), f"sample shape {out.shape}")
            require(bool(np.isfinite(out).all()), "sample not finite")
        counts = launch_counts()
        want = {k: v * steps * clips for k, v in PER_FORWARD_FLOAT.items()}
        log(f"[float] sample_last_only x{clips} (bf16, float taps, {steps} "
            f"DDIM steps): host wall {', '.join(f'{w:.3f}' for w in walls)} s "
            f"per clip (denoise + PNG/WAV export included) | launches {counts}")
        require(counts == want, f"float-path launches {counts} != {want}")
        for name, n in counts.items():
            summary[name]["launches_float_tap_path"] = n
        for k in range(clips):
            _count_files(os.path.join(tmp, f"clip{k}"),
                         ["0_final.png", "0_final.wav"])

    # The chain guard runs on init weights, as the JAX package's own
    # production-chain guard (tpu_tests/test_tpu_fullscale.py:123-145): GN3 = 0
    # there, so every resblock is the identity and the bf16 residual stream is
    # not re-rounded 30 times per forward. The non-zero-GN3 weights of the
    # forward phase run the same chain as a second check, in which every
    # resblock conv counts; the plain bf16 chain is printed for comparison.
    runner = runners[0]
    seq = make_timestep_subsequence(runner.num_timesteps, steps, "uniform")
    x = runner.start_noise()
    sampler, xs, finalize = runner._sampler_for_state(x)
    cfg16 = runner.eval_cfg
    to_flat, _ = flat_io_adapters(cfg_prod)
    prod = ScanSampler(lambda p, xf, t: apply_model_flat_io(p, xf, t, cfg_prod))
    init_params = init_model(torch.Generator().manual_seed(0), cfg)
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
    for label, p, floor, floor_p in (
            ("init weights (GN3 = 0)", init_params, SNR_CHAIN_BF16_DB,
             SNR_CHAIN_PROD_INIT_DB),
            ("non-zero GN3 weights", params, SNR_CHAIN_GN3_BF16_DB,
             SNR_CHAIN_PROD_GN3_DB)):
        p16 = prepare_params(p, cfg16)  # once per run, as the runner
        out_k, ms_k = chain(sampler, xs, p16)
        out_p, ms_p = chain(prod, xs, prepare_params(p, cfg_prod))
        out_32, ms_32 = chain(plain32, x, p)
        out_16, ms_16 = chain(plain16, x, p16)
        require(bool(torch.isfinite(out_k).all()), "kernel chain not finite")
        require(bool(torch.isfinite(out_p).all()), "production chain not finite")
        snr = snr_db(finalize(out_k), out_32)
        snr_p = snr_db(finalize(out_p), out_32)
        log(f"[float] {steps}-step chain, {label}, ms per step: production "
            f"{ms_p / steps:.2f} | bf16 float taps {ms_k / steps:.2f} | bf16 "
            f"plain {ms_16 / steps:.2f} | fp32 plain {ms_32 / steps:.2f}")
        log(f"[float] {steps}-step chain, {label}, SNR vs fp32 plain: bf16 "
            f"float taps {snr:.2f} dB (>= {floor}); production {snr_p:.2f} dB "
            f"(>= {floor_p}); bf16 plain "
            f"{snr_db(out_16, out_32):.2f} dB (for comparison)")
        require(snr >= floor, f"chain SNR ({label}) {snr:.2f} < {floor} dB")
        require(snr_p >= floor_p, f"production chain SNR ({label}) "
                f"{snr_p:.2f} < {floor_p} dB")


def main() -> int:
    import torch

    summary = {}
    try:
        card = phase_device()
        phase_build()
        phase_kernels(summary)
        config, cfg, params = _audio_params()
        phase_forward(config, cfg, params)
        phase_slice(summary, params)
        phase_float_path(summary, config, cfg, params)
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
