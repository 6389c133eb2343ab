"""Where the time of the bf16 tensor-core conv3x3, up and down kernels, of
the int8-tap conv3x3 and of the int8-storage conv3x3 goes, on the card: each
kernel built again with one piece of its work taken out.

    python -m ddim_audio_tpu_torch.tools.conv_ablation [--out FILE]
        [--kernels conv3x3,up,down,int8,store]

Copies ``csrc`` into a temporary folder once per variant, edits the sources
there (``no_mma``: the tap products; ``no_weights``: the weight stream after
the first stages, for the int8 kernel its one staging of the nine taps;
``no_epilogue``: the epilogue, the MMAs kept (the int8 kernel keeps its
quad transpose and statistics and drops its SiLU and stores); ``no_halo``:
the down conv's input-halo copy, the int8 kernel's prefetch of the next
group's raw input, the storage conv's whole prologue pass (its halo left as
it is); ``no_requant``: the int8 kernel's requantisation pass),
builds ``conv3x3.cu``, ``conv_strided.cu``, ``conv3x3_int8.cu``,
``conv3x3_store.cu`` and ``conv_plan.cu`` of each copy with nvcc, all at
once, and times the C entry points (``ddim_conv3x3``, ``ddim_conv_up``,
``ddim_conv_down``, ``ddim_conv3x3_int8``, ``ddim_conv3x3_store``) with
CUDA events at the audio.yml shapes (the storage conv at s0-s3, int8 x with
its scales, ``quant_out``), B = 1 and 2, every fusion on, against the same
call of the unedited build, the unedited build without its fused residual
(``no_residual``; conv3x3, the int8 taps and the storage conv also without
the affine and SiLU prologue: ``no_prologue``) and one cuDNN call of the
bare conv. An edit that does not apply to a kernel
leaves it as built, and its column repeats ``full``. The edited builds
compute wrong results on purpose: only their times mean anything. Prints
one line per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.conv_flat import quantize_store
from ..ops.tile_plan import (
    conv3x3_int8_plan,
    conv3x3_plan,
    conv3x3_store_plan,
    conv_down_plan,
    conv_up_plan,
)

STAGES = [(8192, 256, 32), (4096, 128, 64), (2048, 64, 96), (1024, 32, 128),
          (512, 16, 192), (256, 8, 256)]
UPS = [(4096, 128, 64, 32), (2048, 64, 96, 64), (1024, 32, 128, 96),
       (512, 16, 192, 128), (256, 8, 256, 192)]
DOWNS = [(8192, 256, 32, 64), (4096, 128, 64, 96), (2048, 64, 96, 128),
         (1024, 32, 128, 192), (512, 16, 192, 256)]
SOURCES = ("conv3x3.cu", "conv_strided.cu", "conv3x3_int8.cu",
           "conv3x3_store.cu", "conv_plan.cu")
_MMA = ("warp_mma_k16(acc, aa,", "if (s < 0) warp_mma_k16(acc, aa,")
_RING3 = (r"if \(s \+ kConvStages - 1 < nsteps\)\n      Blk::load_stage",
          "if (false)\n      Blk::load_stage")
# variant → (file, pattern, replacement) edits, each applied to every match;
# a pattern must match. conv3x3.cu and conv3x3_store.cu share their taps
# (conv_mma.cuh's Conv3x3Mma::step)
VARIANTS = {
    "full": [],
    "no_mma": [
        ("conv_mma.cuh", re.escape(_MMA[0]), _MMA[1]),
        ("conv_strided.cu", re.escape(_MMA[0]), _MMA[1]),
        ("conv3x3_int8.cu", r"mma_s8\(acc\[mt\]", "if (grp < 0) mma_s8(acc[mt]")],
    "no_weights": [
        ("conv3x3.cu", *_RING3),
        ("conv3x3_store.cu", *_RING3),
        ("conv_strided.cu", r"if \(s \+ kUpStages - 1 < nsteps\) load_stage",
         "if (false) load_stage"),
        ("conv_strided.cu", r"if \(s \+ kDownStages - 1 < nsteps\) load_stage",
         "if (false) load_stage"),
        ("conv3x3_int8.cu", r"i < 9 \* C \* \(C / 16\)", "i < 0")],
    "no_epilogue": [
        ("conv3x3.cu", r"if \(rem != group_steps - 1\) continue;",
         "if (rem != group_steps - 1 || post_silu >= 0) continue;"),
        ("conv_strided.cu", r"if \(rem != group_steps - 1\) continue;",
         "if (rem != group_steps - 1 || c_out >= 0) continue;"),
        ("conv3x3_int8.cu", r"if \(t < t_len && f < f_len\) \{",
         "if (t < t_len && f < f_len && post_silu < 0) {"),
        ("conv3x3_store.cu",
         r"if \(s % group_steps != group_steps - 1\) continue;",
         "if (s % group_steps != group_steps - 1 || post_silu >= 0) continue;")],
    "no_halo": [
        ("conv_strided.cu", r"i < hn \* cq; i \+= kThreads", "i < 0; ++i"),
        ("conv3x3_int8.cu", r"if \(grp \+ gridDim.x < n_groups\) load_raw",
         "if (false) load_raw"),
        ("conv3x3_store.cu", r"i0 < n_items; i0 \+= kBatch \* kThreads",
         "i0 < 0; i0 += kBatch * kThreads")],
    "no_requant": [
        ("conv3x3_int8.cu", r"if \(hp < kHaloQ\) \{\n        const Vec8 v = unpack8",
         "if (hp < 0) {\n        const Vec8 v = unpack8")],
}
KERNELS = ("conv3x3", "up", "down", "int8", "store")


def build(root: Path) -> dict:
    """One library per variant, built in parallel; each copy sets its own
    shared-memory attribute (the template's guard is shared by every loaded
    copy of the same symbol)."""
    procs = {}
    for name, edits in VARIANTS.items():
        d = root / name
        shutil.copytree(_cuda.CSRC, d)
        for fn in ("conv3x3.cu", "conv_strided.cu", "conv3x3_int8.cu",
                   "conv3x3_store.cu"):
            q = d / fn
            q.write_text(q.read_text()
                         .replace("static bool raised = false;",
                                  "bool raised = false;")
                         .replace("static int grid_cap = 0;",
                                  "int grid_cap = 0;"))
        for fn, pat, rep in edits:
            q = d / fn
            text, n = re.subn(pat, rep, q.read_text())
            if n == 0:
                raise RuntimeError(f"{name}: no match for {pat} in {fn}")
            q.write_text(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), *[str(d / s) for s in SOURCES]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        lib.ddim_conv3x3.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        lib.ddim_conv_up.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.ddim_conv_down.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.ddim_conv3x3_int8.argtypes = [ctypes.c_void_p] * 9 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.ddim_conv3x3_store.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    args = ap.parse_args(argv)
    todo = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("conv_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    emit(smi.stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale)

    st = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        libs = build(Path(tmp))
        for bsz in (1, 2):
            for t, f, c in STAGES if "conv3x3" in todo else ():
                x, res = rnd(bsz, t, f * c).bfloat16(), rnd(bsz, t, f * c).bfloat16()
                w = rnd(3, 3, c, c, scale=(9 * c) ** -0.5).bfloat16()
                sc, sh, add = 1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c), rnd(bsz, c)
                out = torch.empty_like(x)
                stats = torch.empty(bsz, conv3x3_plan(t, f, c, True, bsz).tiles,
                                    2, c, device="cuda")
                row = [f"conv3x3 B{bsz} T{t} F{f} C{c}"]
                for name, lib in libs.items():
                    def run(lib=lib, res_on=True, pre_on=True):
                        err = lib.ddim_conv3x3(
                            x.data_ptr(), res.data_ptr() if res_on else None,
                            sc.data_ptr() if pre_on else None,
                            sh.data_ptr() if pre_on else None, w.data_ptr(),
                            add.data_ptr(), out.data_ptr(), stats.data_ptr(),
                            bsz, t, f, c, int(pre_on), 1, 1, st)
                        if err:
                            raise RuntimeError(f"ddim_conv3x3 {name}: {err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                    if name == "full":
                        row.append("no_residual "
                                   f"{cuda_ms(lambda: run(res_on=False)):.4f}")
                        row.append("no_prologue "
                                   f"{cuda_ms(lambda: run(res_on=False, pre_on=False)):.4f}")
                wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                xn = x.view(bsz, t, f, c).permute(0, 3, 1, 2)
                row.append(f"cudnn {cuda_ms(lambda: F.conv2d(xn, wl, padding=1)):.4f}")
                emit(" | ".join(row))
            for t, f, ci, co in UPS if "up" in todo else ():
                x = rnd(bsz, t, f * ci).bfloat16()
                w = rnd(4, 4, ci, co, scale=(4 * ci) ** -0.5).bfloat16()
                bias, res = rnd(co), rnd(bsz, 2 * t, 2 * f * co).bfloat16()
                out = torch.empty_like(res)
                stats = torch.empty(bsz, conv_up_plan(t, f, ci, co, True, bsz).tiles,
                                    2, co, device="cuda")
                row = [f"up B{bsz} T{t} F{f} {ci}->{co}"]
                for name, lib in libs.items():
                    def run(lib=lib, res_on=True):
                        err = lib.ddim_conv_up(
                            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                            res.data_ptr() if res_on else None, out.data_ptr(),
                            stats.data_ptr(), bsz, t, f, ci, co, 1, st)
                        if err:
                            raise RuntimeError(f"ddim_conv_up {name}: {err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                    if name == "full":
                        row.append("no_residual "
                                   f"{cuda_ms(lambda: run(res_on=False)):.4f}")
                wl = w.permute(2, 3, 0, 1).flip(2, 3).contiguous(
                    memory_format=torch.channels_last)
                xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
                lib_ms = cuda_ms(lambda: F.conv_transpose2d(xn, wl, stride=2,
                                                            padding=1))
                row.append(f"cudnn {lib_ms:.4f}")
                emit(" | ".join(row))
            for t, f, ci, co in DOWNS if "down" in todo else ():
                x = rnd(bsz, t, f * ci).bfloat16()
                w = rnd(4, 4, ci, co, scale=(16 * ci) ** -0.5).bfloat16()
                bias = rnd(co)
                out = torch.empty(bsz, t // 2, (f // 2) * co, device="cuda",
                                  dtype=torch.bfloat16)
                stats = torch.empty(
                    bsz, conv_down_plan(t, f, ci, co, True, bsz).tiles, 2, co,
                    device="cuda")
                row = [f"down B{bsz} T{t} F{f} {ci}->{co}"]
                for name, lib in libs.items():
                    def run(lib=lib):
                        err = lib.ddim_conv_down(
                            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), stats.data_ptr(), bsz, t, f, ci,
                            co, 1, st)
                        if err:
                            raise RuntimeError(f"ddim_conv_down {name}: {err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
                lib_ms = cuda_ms(lambda: F.conv2d(xn, wl, stride=2, padding=1))
                row.append(f"cudnn {lib_ms:.4f}")
                emit(" | ".join(row))
            for t, f, c in STAGES[:3] if "int8" in todo else ():
                x, res = rnd(bsz, t, f * c).bfloat16(), rnd(bsz, t, f * c).bfloat16()
                w = rnd(3, 3, c, c, scale=(9 * c) ** -0.5)
                wq_t = torch.randint(-127, 128, (3, 3, c, c), generator=g,
                                     device="cuda").to(torch.int8)
                s_w = w.abs().amax(dim=(0, 1, 2)) / 127
                sc, sh, add = 1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c), rnd(bsz, c)
                out = torch.empty_like(x)
                stats = torch.empty(
                    bsz, conv3x3_int8_plan(t, f, c, True, bsz).tiles, 2, c,
                    device="cuda")
                row = [f"int8 B{bsz} T{t} F{f} C{c}"]
                for name, lib in libs.items():
                    def run(lib=lib, res_on=True, pre_on=True):
                        err = lib.ddim_conv3x3_int8(
                            x.data_ptr(), res.data_ptr() if res_on else None,
                            sc.data_ptr() if pre_on else None,
                            sh.data_ptr() if pre_on else None, wq_t.data_ptr(),
                            s_w.data_ptr(), add.data_ptr(), out.data_ptr(),
                            stats.data_ptr(), bsz, t, f, c, int(pre_on), 1, 1,
                            st)
                        if err:
                            raise RuntimeError(f"ddim_conv3x3_int8 {name}: {err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                    if name == "full":
                        row.append("no_residual "
                                   f"{cuda_ms(lambda: run(res_on=False)):.4f}")
                        row.append("no_prologue "
                                   f"{cuda_ms(lambda: run(res_on=False, pre_on=False)):.4f}")
                wl = w.bfloat16().permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                xn = x.view(bsz, t, f, c).permute(0, 3, 1, 2)
                row.append(f"cudnn {cuda_ms(lambda: F.conv2d(xn, wl, padding=1)):.4f}")
                emit(" | ".join(row))
            for t, f, c in STAGES[:4] if "store" in todo else ():
                x = rnd(bsz, t, f, c)
                q, qs = quantize_store(x)
                w = rnd(3, 3, c, c, scale=(9 * c) ** -0.5).bfloat16()
                sc, sh, add = 1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c), rnd(bsz, c)
                out = torch.empty_like(q)
                out_sc = torch.empty_like(qs)
                stats = torch.empty(
                    bsz, conv3x3_store_plan(t, f, c, True, bsz, 1).tiles, 2, c,
                    device="cuda")
                row = [f"store B{bsz} T{t} F{f} C{c}"]
                for name, lib in libs.items():
                    def run(lib=lib, pre_on=True):
                        err = lib.ddim_conv3x3_store(
                            q.data_ptr(), qs.data_ptr(), None, None,
                            sc.data_ptr() if pre_on else None,
                            sh.data_ptr() if pre_on else None, w.data_ptr(),
                            add.data_ptr(), out.data_ptr(), out_sc.data_ptr(),
                            stats.data_ptr(), bsz, t, f, c, 1, 0, int(pre_on),
                            1, 1, st)
                        if err:
                            raise RuntimeError(f"ddim_conv3x3_store {name}: {err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                    if name == "full":
                        row.append("no_prologue "
                                   f"{cuda_ms(lambda: run(pre_on=False)):.4f}")
                wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                xn = x.bfloat16().permute(0, 3, 1, 2)
                row.append(f"cudnn {cuda_ms(lambda: F.conv2d(xn, wl, padding=1)):.4f}")
                emit(" | ".join(row))
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
