"""Where the time of the bf16 tensor-core conv3x3, up and down kernels, of
the int8-tap conv3x3, of the int8-storage conv3x3, of the head and tail
convs, of the fp32 conv3x3, up and down convs (training's), of the int8-tap
up and down convs and of the fp32 weight gradients of the down, 3×3 and up
convs goes, on the card: each kernel built again with one piece of its work
taken out.

    python -m ddim_audio_tpu_torch.tools.conv_ablation [--out FILE]
        [--kernels conv3x3,up,down,int8,store,head,tail,down32,upi8,conv32,up32,downi8,downdw32,dw32,updw32]
        [--csrc DIR]

Copies ``csrc`` (or ``--csrc``, another checkout's kernel sources, e.g. a
parent's unpacked under ``exp/parent/``) into a temporary folder once per
variant, edits the sources there (``no_mma``: the tap products, for the
head and tail on CUDA cores their FMAs; ``no_weights``: the weight stream
after the first stages, for the int8 kernel its one staging of the nine
taps, for the head and tail their weight loads; ``no_epilogue``: the
epilogue, the MMAs kept (the int8 kernel keeps its quad transpose and
statistics and drops its SiLU and stores; the tensor-core head drops its
bulk stores, the tensor-core tail its shifted sum and stores, the CUDA-core
tail its shuffle tree and stores); ``no_halo``: the down conv's input-halo
copy, the int8 kernel's prefetch of the next group's raw input, the
storage conv's whole prologue pass (its halo left as it is), the
tensor-core head's prefetch of the next tile's halo and the tensor-core
tail's input rows after the first kTailStages (the CUDA-core head and tail:
their halo staging); ``no_requant``: the int8 kernel's requantisation pass;
``no_stats``: the head's statistics). ``down32`` (the fp32 down conv at
the training shapes of one microbatch [1, 2, 1024, 256]) and ``upi8`` (the
int8-tap up conv in bf16 at 64->32 and 256->192) take the same variants
with their own edits, each listed for the CUDA-core / two-pass kernels
they had first and for their redesigned ones: ``no_mma`` the FMAs or
MMAs, ``no_weights`` the weight staging, ``no_halo`` the input halo (down32:
its copies; upi8: the first kernel's amax pass over global memory, the
persistent one's prefetch of the next group's raw halo), ``no_requant``
(upi8) the requantisation pass and ``no_epilogue`` the stores. ``conv32``
and ``up32`` (the fp32 conv3x3 with every fusion on and the fp32 up conv
with the skip residual, both with statistics, at the training shapes,
against fp32 cuDNN with TF32 off) likewise, for their CUDA-core kernels and
their split-TF32 ones: ``no_mma`` the FMAs or MMAs, ``no_weights`` the
weights (the split-TF32 ring after its first stages), ``no_halo`` the halo
(the CUDA-core conv3x3's staging pass with its prologue; the split-TF32
kernels' raw chunk copies after the first), ``no_epilogue`` add or bias,
residual, SiLU, statistics and stores, and for the split-TF32 kernels
``no_split`` (the split at staging: the chunk into the hi plane as it is),
which a checkout without it builds unedited. ``downi8`` (the int8-tap down
conv in bf16 at 32->64, with statistics) takes ``upi8``'s edits, which
list alternatives for the two-pass down kernel first written and for the
persistent one (``no_halo``: the amax pass over global memory, the
prefetch of the next group's raw halo; ``no_requant`` the requant;
``no_weights`` the weights restaged per chunk, staged once a block).
``downdw32`` (the fp32 down-conv weight gradient at the five training
transitions, against one fp32 ``conv2d_weight`` with TF32 off, the
partials' sum included as the wrapper does it), ``dw32`` (the fp32 3×3
weight gradient at the six training stages) and ``updw32`` (the fp32
up-conv weight gradient at the five up transitions, x at the lower stage)
take ``no_mma`` (the FMAs or MMAs), ``no_halo`` (the x halo's staging),
``no_g`` (the other operand: the g tile's staging), ``no_epilogue`` (the
partials' stores) and ``no_split`` (the split into TF32 hi and lo planes),
and the unedited build without the wrapper's sum of the partials
(``no_reduce``); ``dw32`` and ``updw32`` also the designs not taken:
``tile64`` (the 3×3 dW on tiles of 64 base positions, not 128),
``ksets1`` (its three warps a block, not two sets of three over a tile's
k8 steps) and ``up64`` (the up dW on tiles of 64 base positions at one
block an SM, not 32 at two), each of which a checkout without them builds
unedited. Builds
``conv3x3.cu``, ``conv_strided.cu``, ``conv_strided_int8.cu``,
``conv3x3_int8.cu``, ``conv3x3_store.cu``, ``conv_head_tail.cu``,
``conv_dw.cu`` and ``conv_plan.cu`` of each copy with nvcc, all at once,
and times the C entry points (``ddim_conv3x3``, ``ddim_conv_up``,
``ddim_conv_down``, ``ddim_conv3x3_int8``, ``ddim_conv3x3_store``,
``ddim_conv_head``, ``ddim_conv_tail``, ``ddim_conv_down_int8``,
``ddim_conv_dw``, and ``ddim_conv_up_int8`` or, in a checkout that predates
it, ``ddim_conv_strided_int8``) with CUDA events, the card held
busy while the host queues the timed calls, at the audio.yml
shapes (the storage conv at s0-s3, int8 x with its scales, ``quant_out``;
the head with statistics and the tail with its residual at 8192 x 256), B =
1 and 2, every fusion on, against the same call of the unedited build, the
unedited build without its fused residual (``no_residual``; conv3x3, the
int8 taps and the storage conv also without the affine and SiLU prologue:
``no_prologue``) and one cuDNN call of the bare conv (fp32 with TF32 off
for ``down32``). An edit of ``conv_head_tail.cu``, ``conv_strided.cu``'s
fp32 down or ``conv_strided_int8.cu``'s up lists alternatives for the
kernels first written and for the redesigned ones, so a parent's sources
take the same variants. An edit
that does not apply to a kernel leaves it as built, and its column repeats
``full``. The edited builds compute wrong results on purpose: only their
times mean anything. Prints one line per shape.
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
from torch.nn.grad import conv2d_weight

from ..ops import _cuda
from ..ops.conv_flat import quantize_store
from ..ops.tile_plan import (
    _fma_plan,
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
HEAD_TAIL = [(8192, 256)]  # the head's input and the tail's output (T, F)
TRAIN_DOWNS = [(1024, 256, 32, 64), (512, 128, 64, 96), (256, 64, 96, 128),
               (128, 32, 128, 192), (64, 16, 192, 256)]
UPS_I8 = [(4096, 128, 64, 32), (256, 8, 256, 192)]
TRAIN_STAGES = [(1024, 256, 32), (512, 128, 64), (256, 64, 96), (128, 32, 128),
                (64, 16, 192), (32, 8, 256)]
TRAIN_UPS = [(t // 2, f // 2, co, ci) for t, f, ci, co in TRAIN_DOWNS]
DOWNS_I8 = [(8192, 256, 32, 64)]
SOURCES = ("conv3x3.cu", "conv_strided.cu", "conv_strided_int8.cu",
           "conv3x3_int8.cu", "conv3x3_store.cu", "conv_head_tail.cu",
           "conv_dw.cu", "conv_plan.cu")
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
    "no_stats": [],
}
# The head and tail (conv_head_tail.cu), the fp32 down conv (conv_strided.cu)
# and the int8-tap up conv (conv_strided_int8.cu): each edit lists
# alternatives, for the kernels first written and for the redesigned ones;
# at least one of each edit's alternatives must match, so that --csrc can
# take a checkout that has only the first ones.
HEAD_TAIL_EDITS = {
    "no_mma": [
        # head: the FMAs (CUDA cores); the k16 and k8 MMAs (tensor cores)
        ((r"acc\[i\] = fmaf\(xs\[", "if (tap < 0) acc[i] = fmaf(xs["),
         (r"\n              mma_bf16_from\(",
          "\n              if (tile >= 0) { acc[u][nt][0] = acc[u][nt][1] = "
          "acc[u][nt][2] = acc[u][nt][3] = bs[nt][0]; } else mma_bf16_from("),
         (r"\n              mma_bf16\(acc\[u\]\[nt\], a, bw\[s\]",
          "\n              if (tile < 0) mma_bf16(acc[u][nt], a, bw[s]"),
         (r"mma_bf16_k8\(acc\[u\]\[nt\], a0, a1, bw8",
          "if (tile < 0) mma_bf16_k8(acc[u][nt], a0, a1, bw8")),
        # tail: the FMAs; the MMAs
        ((r"acc\[i\]\[co\] = fmaf\(v, wr", "if (tap < 0) acc[i][co] = fmaf(v, wr"),
         (r"mma_bf16\(acc\[nt\], a, \*reinterpret_cast",
          "if (j < 0) mma_bf16(acc[nt], a, *reinterpret_cast")),
    ],
    "no_weights": [
        # head: the 9·Cin·32 weights staged from global memory; the B
        # fragments' loads
        ((r"idx < 9 \* c_in \* kCoTile; idx \+= kThreads",
          "idx < 0; idx += kThreads"),
         (r"bf16_bits\(w\[k \* C0 \+ ch\]\)", "(uint32_t)(k + ch)")),
        # tail: the lane's 9·Cout weights from global memory; the staged B
        ((r"wr\[tap\]\[co\] =\s*to_f\(w\[\(\(size_t\)tap \* c0 \+ c0s \+ lane\) \* COUT \+ co\]\);",
          "wr[tap][co] = 0.5f * (tap + co + lane);"),
         (r"\? w\[\(\(size_t\)\(dt \* 3 \+ df\) \* c0 \+ ci\) \* COUT \+ co\]",
          "? __float2bfloat16((float)(k + n))")),
    ],
    "no_halo": [
        # head: the Cin-wide halo; the next tile's halo copy
        ((r"idx < hn \* c_in; idx \+= kThreads", "idx < 0; idx += kThreads"),
         (r"if \(nxt < n_tiles\) load_halo", "if (nxt < 0) load_halo")),
        # tail: the summed, rounded 10 × 18 × 32 halo; the rows streamed in
        # after the first kTailStages
        ((r"idx < kTailHalo \* kTailCk / 8;", "idx < 0;"),
         (r"\n    load_raw\(j \+ S\);", "\n    if (j < 0) load_raw(j + S);")),
    ],
    "no_epilogue": [
        # head: bias, statistics and stores; the bulk store of each tile
        ((r"if \(t < t_len && f < f_len && co < c0\) \{",
          "if (t < t_len && f < f_len && co < c0 && c_in < 0) {"),
         (r"if \(threadIdx.x == 0\) \{  // the tile's rows",
          "if (threadIdx.x == 0 && t_len < 0) {  // the tile's rows")),
        # tail: the shuffle tree over the lanes and the stores; the shifted
        # sum of P and the stores
        ((r"for \(int m = 16; m > 0; m >>= 1\)\n        acc\[i\]\[co\]",
          "for (int m = 16; m > c0; m >>= 1)\n        acc[i][co]"),
         (r"if \(j >= 3\) epilogue\(", "if (j >= 3 && c0 < 0) epilogue(")),
        ((r"if \(e < kTailFt \* COUT && f < f_len\)",
          "if (e < kTailFt * COUT && f < f_len && c0 < 0)"),
         (r"\n  epilogue\(r1 - 1\);", "\n  if (c0 < 0) epilogue(r1 - 1);")),
    ],
    "no_stats": [
        # head: the block's partial (its barrier and stores); the per-value
        # (sum, sum²) in registers
        ((r"if \(stats != nullptr\) \{\n    float\* dst",
          "if (stats != nullptr && c_in < 0) {\n    float* dst"),
         (r"if \(ok\[u\]\[hh\]\) \{", "if (ok[u][hh] && t_len < 0) {")),
    ],
}
DOWN32_EDITS = {
    "no_mma": [
        # the CUDA-core FMAs; the split-TF32 MMAs
        ((r"acc\[i\] = fma4\(acc\[i\], v, w0, w1, w2, w3\);",
          "if (tap < 0) acc[i] = fma4(acc[i], v, w0, w1, w2, w3);"),
         (r"mma_tf32x3\(acc", "if (s < 0) mma_tf32x3(acc")),
    ],
    "no_weights": [
        # the weights of each 8-channel chunk (down and up on CUDA cores);
        # the split-TF32 rings after their first stages (down; up)
        ((r"idx < 16 \* kCkS \* kCoTile; idx \+= kThreads",
          "idx < 0; idx += kThreads"),
         (r"if \(s \+ kTf32Stages - 1 < s_hi\) load_stage",
          "if (false) load_stage"),
         (r"if \(nxt < s_hi\) load_weights", "if (false) load_weights")),
    ],
    "no_halo": [
        # the halo of each 8-channel chunk (down and up on CUDA cores); the
        # split-TF32 down's 16-channel halo chunks; the split-TF32 up's raw
        # chunk copies after the first
        ((r"idx < hn \* kCkS; idx \+= kThreads", "idx < 0; idx += kThreads"),
         (r"i < hn \* kTf32Q; i \+= kThreads", "i < 0; i += kThreads"),
         (r"if \(nxt < s_hi && nxt % kSteps == 0\) load_raw",
          "if (false) load_raw")),
    ],
    "no_epilogue": [
        # bias, statistics and stores
        ((r"if \(t < t_out && f < f_out && co < c_out\) \{\n"
          r"      const float o = acc\[i\] \+ bias\[co\];",
          "if (t < t_out && f < f_out && co < c_out && c_in < 0) {\n"
          "      const float o = acc[i] + bias[co];"),
         (r"const bool inside = t < t_out && f < f_out;",
          "const bool inside = t < t_out && f < f_out && c_in < 0;")),
        # the up conv's bias, residual, statistics and stores (CUDA cores;
        # split TF32)
        ((r"if \(t < t_out && f < f_out && co < c_out\) \{\n"
          r"      const size_t off",
          "if (t < t_out && f < f_out && co < c_out && c_in < 0) {\n"
          "      const size_t off"),
         (r"if \(i < t_in && j < f_in\) \{  // the epilogue",
          "if (i < t_in && j < f_in && c_in < 0) {  // the epilogue")),
    ],
}
# The fp32 conv3x3 (conv3x3.cu): the CUDA-core kernel first written and the
# split-TF32 one
CONV32_EDITS = {
    "no_mma": [
        ((r"acc\[i\] = fma4\(acc\[i\], v, w0, w1, w2, w3\);",
          "if (tap < 0) acc[i] = fma4(acc[i], v, w0, w1, w2, w3);"),
         (r"mma_tf32x3\(acc", "if (s < 0) mma_tf32x3(acc")),
    ],
    "no_weights": [
        ((r"idx < 9 \* kCk3 \* kCoTile; idx \+= kThreads",
          "idx < 0; idx += kThreads"),
         (r"if \(nxt < s_hi\) load_weights", "if (false) load_weights")),
    ],
    "no_halo": [
        # the staging pass with its prologue; the raw chunk copies after
        # the first
        ((r"idx < hn \* kCk3; idx \+= kThreads", "idx < 0; idx += kThreads"),
         (r"if \(nxt < s_hi && nxt % 3 == 0\) load_raw",
          "if (false) load_raw")),
    ],
    "no_epilogue": [
        ((r"if \(t < t_len && f < f_len && co < c\) \{",
          "if (t < t_len && f < f_len && co < c && pre_silu < 0) {"),
         (r"if \(t < t_len && f < f_len\) \{  // the epilogue",
          "if (t < t_len && f < f_len && c < 0) {  // the epilogue")),
    ],
}
# The split-TF32 conv3x3 and up's split at staging (conv_mma.cuh): the
# chunk stored into the hi plane as it is. A checkout without it builds this
# variant unedited.
TF32_SPLIT_EDITS = {
    "no_split": [
        ((r"uint4 h, l;\n  split_tf32\(v\.x, h\.x, l\.x\);\n"
          r"  split_tf32\(v\.y, h\.y, l\.y\);\n"
          r"  split_tf32\(v\.z, h\.z, l\.z\);\n"
          r"  split_tf32\(v\.w, h\.w, l\.w\);",
          "const uint4 h = make_uint4(__float_as_uint(v.x), "
          "__float_as_uint(v.y), __float_as_uint(v.z), __float_as_uint(v.w));"
          "\n  const uint4 l = make_uint4(0u, 0u, 0u, 0u);"),),
    ],
}
OPTIONAL = ("no_split", "tile64", "ksets1", "up64")
UPI8_EDITS = {
    "no_mma": [
        # the int8 MMAs of the two-pass kernel; of the persistent one
        ((r"mma_s8\(acc\[nt\], a,", "if (kc < 0) mma_s8(acc[nt], a,"),
         (r"mma_s8\(acc\[2 \* np", "if (grp < 0) mma_s8(acc[2 * np")),
    ],
    "no_weights": [
        # all 16 taps' weights restaged per 32-channel chunk; staged once a
        # block
        ((r"idx < 16 \* 8 \* \(CO / 4\); idx \+= kThreads",
          "idx < 0; idx += kThreads"),
         (r"i < 16 \* CO \* \(CI / 16\); i \+= kThreads",
          "i < 0; i += kThreads"),
         (r"i < 16 \* CO \* NP; i \+= kThreads", "i < 0; i += kThreads")),
    ],
    "no_halo": [
        # the amax pass over global memory; the next group's raw halo
        ((r"if \(t >= 0 && t < t_in && f >= 0 && f < f_in\) \{\n"
          r"      const Vec8 v = load8\(x \+ xb \+ \(\(size_t\)t \* f_in \+ f\) "
          r"\* c_in \+ ch\);\n#pragma unroll\n      for \(int k = 0; k < 8; \+\+k\) am",
          "if (t < 0 && t >= 0) {\n"
          "      const Vec8 v = load8(x + xb + ((size_t)t * f_in + f) * c_in + ch);"
          "\n#pragma unroll\n      for (int k = 0; k < 8; ++k) am"),
         (r"if \(grp \+ gridDim.x < n_groups\) load_raw",
          "if (false) load_raw"),
         (r"if \(more\) load_raw", "if (false) load_raw")),
    ],
    "no_requant": [
        # the second global pass that requantises; the requant from the
        # registers
        ((r"uint32_t lo = 0, hi = 0;\n    if \(t >= 0",
          "uint32_t lo = 0, hi = 0;\n    if (t < 0 && t >= 0"),
         (r"if \(i < kItems\) \{  // requantise",
          "if (i < 0) {  // requantise"),
         (r"put_q\(i, ", "if (i < 0) put_q(i, ")),
    ],
    "no_epilogue": [
        # dequant, residual, statistics and stores
        ((r"if \(t < t_out && f < f_out\) \{\n        const size_t off",
          "if (t < t_out && f < f_out && c_in < 0) {\n        const size_t off"),
         (r"if \(ok\[r\]\) \{  // the lane's 8 channels",
          "if (ok[r] && c_out < 0) {  // the lane's 8 channels"),
         (r"if \(t < t_out && f < f_out\) \{  // the lane's 8 channels",
          "if (t < t_out && f < f_out && c_out < 0) {  // the lane's 8 "
          "channels")),
    ],
}
# The fp32 weight gradients (conv_dw.cu): the CUDA-core kernel first
# written (all three modes share its loops) and the split-TF32 one (its
# copies stride kThreads, since it takes every mode NTH)
_DW_COPY = (r"i < {n} \* \({c} / 4\); i \+= (?:kThreads|NTH)\) \{{\n"
            r"      const int {p} = i / \({c} / 4\), q = i % \({c} / 4\);\n"
            r"      const int t = ")
DW32_EDITS = {
    "no_mma": [
        ((r"for \(int p = 0; p < G::NP; \+\+p\) \{",
          "for (int p = 0; p < G::NP * (c_in < 0); ++p) {"),
         (r"mma_tf32x3\(sum\[u\]\[nt\]", "if (tile < 0) mma_tf32x3(sum[u][nt]")),
    ],
    "no_g": [
        # g: the CUDA-core kernel's staging; the split-TF32 one's copies
        ((r"idx < gr \* gw \* kCoTile; idx \+= kThreads",
          "idx < 0; idx += kThreads"),
         (_DW_COPY.format(n="hg", c="CO", p="gp"),
          "i < 0; i += kThreads) {\n"
          "      const int gp = i / (CO / 4), q = i % (CO / 4);\n"
          "      const int t = ")),
    ],
    "no_halo": [
        ((r"idx < hr \* hw \* kDwCi; idx \+= kThreads",
          "idx < 0; idx += kThreads"),
         (_DW_COPY.format(n="hx", c="CI", p="hp"),
          "i < 0; i += kThreads) {\n"
          "      const int hp = i / (CI / 4), q = i % (CI / 4);\n"
          "      const int t = ")),
    ],
    "no_epilogue": [
        ((r"if \(ci < c_in && co < c_out\)\n        part\[",
          "if (ci < c_in && co < c_out && c_in < 0)\n        part["),
         (r"\*reinterpret_cast<float2\*>\(dst",
          "if (c_in < 0) *reinterpret_cast<float2*>(dst")),
    ],
}
# The split-TF32 weight gradients' designs not taken (conv_plan.h, and the
# occupancy check conv_dw.cu makes against the plan), timed as variants:
# ``tile64`` the 3×3 dW (mode 0) on tiles of 64 base positions (56 KB)
# rather than 128 (103 KB); ``ksets1`` its three warps a block rather than
# two sets of three over a tile's k8 steps; ``up64`` the up dW (mode 2) on
# tiles of 64 base positions at one block an SM (142 KB) rather than 32 at
# two. A checkout without them builds these variants unedited.
DW_DESIGN_EDITS = {
    "tile64": [((r"kDw3Tf32Pos = 128;", "kDw3Tf32Pos = 64;"),)],
    "ksets1": [((r"kDw3KSets = 2;", "kDw3KSets = 1;"),)],
    "up64": [((r"while \(p\.tile_t > 1 &&\n         kDwTf32Blocks \*",
               "while (p.tile_t > 1 &&\n         (mode == 2 ? 1 : kDwTf32Blocks) *"),)],
}
DW_DESIGN_CHECK = {
    "up64": [((r"if \(resident < kDwTf32Blocks\)",
               "if (resident < (MODE == 2 ? 1 : kDwTf32Blocks))"),)],
}
ALT_EDITS = {"conv_head_tail.cu": HEAD_TAIL_EDITS,
             "conv_strided.cu": DOWN32_EDITS,
             "conv_strided_int8.cu": UPI8_EDITS,
             "conv3x3.cu": CONV32_EDITS,
             "conv_mma.cuh": TF32_SPLIT_EDITS,
             "conv_dw.cu": {**DW32_EDITS, **DW_DESIGN_CHECK},
             "conv_plan.h": DW_DESIGN_EDITS}
KERNELS = ("conv3x3", "up", "down", "int8", "store", "head", "tail", "down32",
           "upi8", "conv32", "up32", "downi8", "downdw32", "dw32", "updw32")
# the variants each fp32 / int8 kind's own edits add
KIND_EDITS = {"down32": DOWN32_EDITS, "upi8": UPI8_EDITS,
              "downi8": UPI8_EDITS,
              # the split at staging: conv_mma.cuh's store_split_tf32
              "downdw32": {**DW32_EDITS, **TF32_SPLIT_EDITS},
              "dw32": {**DW32_EDITS, **TF32_SPLIT_EDITS, **DW_DESIGN_EDITS},
              "updw32": {**DW32_EDITS, **TF32_SPLIT_EDITS, **DW_DESIGN_EDITS},
              "conv32": {**CONV32_EDITS, **TF32_SPLIT_EDITS},
              "up32": {**DOWN32_EDITS, **TF32_SPLIT_EDITS}}


def apply_alternatives(d: Path, name: str) -> dict:
    """The edits of ALT_EDITS for variant ``name`` in the copy ``d``; each
    edit needs at least one of its alternatives to match (but for the
    OPTIONAL variants). Returns the matches of every alternative, by
    file."""
    hits_of = {}
    for fn, edits in ALT_EDITS.items():
        q = d / fn
        for alternatives in edits.get(name, ()):
            text, hits = q.read_text(), []
            for pat, rep in alternatives:
                text, n = re.subn(pat, rep, text)
                hits.append(n)
            if not any(hits) and name not in OPTIONAL:
                raise RuntimeError(f"{name}: no match for any of "
                                   f"{[a[0] for a in alternatives]} in {fn}")
            hits_of.setdefault(fn, []).append(hits)
            q.write_text(text)
    return hits_of


def build(root: Path, csrc: Path, variants) -> dict:
    """One library per variant, built in parallel from a copy of ``csrc``;
    each copy sets its own shared-memory attribute (the template's guard is
    shared by every loaded copy of the same symbol)."""
    procs = {}
    for name in variants:
        d = root / name
        shutil.copytree(csrc, d)
        for fn in ("conv3x3.cu", "conv_strided.cu", "conv_strided_int8.cu",
                   "conv3x3_int8.cu", "conv3x3_store.cu", "conv_head_tail.cu",
                   "conv_dw.cu"):
            q = d / fn
            q.write_text(q.read_text()
                         .replace("static bool raised = false;",
                                  "bool raised = false;")
                         .replace("static int raised = 48 * 1024;",
                                  "int raised = 48 * 1024;")
                         .replace("static int grid_cap = 0;",
                                  "int grid_cap = 0;")
                         .replace("static int resident = 0;",
                                  "int resident = 0;"))
        for fn, pat, rep in VARIANTS.get(name, ()):
            q = d / fn
            text, n = re.subn(pat, rep, q.read_text())
            if n == 0:
                raise RuntimeError(f"{name}: no match for {pat} in {fn}")
            q.write_text(text)
        apply_alternatives(d, name)
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
        lib.ddim_conv_head.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.ddim_conv_tail.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        # the persistent kernel's library takes wq and wq_t
        lib.ddim_conv_down_int8.argtypes = [ctypes.c_void_p] * (
            7 if down_int8_takes_t(lib) else 6) + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.ddim_conv_dw.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.ddim_conv_dw_splits.argtypes = [ctypes.c_int] * 7
        if hasattr(lib, "ddim_conv_up_int8"):  # the persistent up kernel
            lib.ddim_conv_up_int8.argtypes = [ctypes.c_void_p] * 7 \
                + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        else:  # a checkout that predates it
            lib.ddim_conv_strided_int8.argtypes = [ctypes.c_void_p] * 7 \
                + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


# Cycles the card sleeps before the timed calls (~25-35 ms), so that the
# events time the card alone and not the host's calls (chip_smoke.py).
PREFILL_CYCLES = 50_000_000


def up_weight(w):
    """Stored equivalent-forward HWIO [4, 4, C_in, C_out] → the
    channels-last ConvTranspose2d weight cuDNN takes."""
    return w.permute(2, 3, 0, 1).flip(2, 3).contiguous(
        memory_format=torch.channels_last)


def down_int8_takes_t(lib) -> bool:
    """Whether the library's int8 down conv also takes the [4, 4, C_out,
    C_in] weights (the persistent kernel's: its plan query exists)."""
    return hasattr(lib, "ddim_conv_down_int8_plan")


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    ap.add_argument("--csrc", default=str(_cuda.CSRC),
                    help="the kernel sources to ablate (default: this "
                    "package's; another checkout's csrc for a parent)")
    args = ap.parse_args(argv)
    todo = set(args.kernels.split(","))
    if not todo <= set(KERNELS):
        print(f"conv_ablation: --kernels is a subset of {','.join(KERNELS)}",
              file=sys.stderr)
        return 2
    # the variants that edit something the chosen kernels run
    variants = ["full"]
    if todo - {"head", "tail", "conv32", "up32"}:
        variants += [v for v, e in VARIANTS.items() if e]
    if todo & {"head", "tail"}:
        variants += [v for v in HEAD_TAIL_EDITS if v not in variants]
    for kind, edits in KIND_EDITS.items():
        if kind in todo:
            variants += [v for v in edits if v not in variants]
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

    # the fp32 reference conv in true fp32 (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    st = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        libs = build(Path(tmp), Path(args.csrc), variants)
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
                wl = up_weight(w)
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
            for t, f, ci, co in TRAIN_DOWNS if "down32" in todo else ():
                x = rnd(bsz, t, f * ci)
                w = rnd(4, 4, ci, co, scale=(16 * ci) ** -0.5)
                bias = rnd(co)
                out = torch.empty(bsz, t // 2, (f // 2) * co, device="cuda")
                # as many partials as either kernel writes (the CUDA-core
                # one's 64-position tiles are the smallest)
                stats = torch.empty(bsz, _fma_plan(t // 2, f // 2, co).tiles,
                                    2, co, device="cuda")
                row = [f"down32 B{bsz} T{t} F{f} {ci}->{co}"]
                for name, lib in libs.items():
                    def run(lib=lib):
                        err = lib.ddim_conv_down(
                            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), stats.data_ptr(), bsz, t, f, ci,
                            co, 0, st)
                        if err:
                            raise RuntimeError(f"ddim_conv_down fp32 {name}: "
                                               f"{err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
                lib_ms = cuda_ms(lambda: F.conv2d(xn, wl, stride=2, padding=1))
                row.append(f"cudnn_fp32 {lib_ms:.4f}")
                emit(" | ".join(row))
            for t, f, c in TRAIN_STAGES if "conv32" in todo else ():
                x, res = rnd(bsz, t, f * c), rnd(bsz, t, f * c)
                w = rnd(3, 3, c, c, scale=(9 * c) ** -0.5)
                sc, sh, add = 1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c), rnd(bsz, c)
                out = torch.empty_like(x)
                # as many partials as either kernel writes (the CUDA-core
                # one's 64-position tiles are the smallest)
                stats = torch.empty(bsz, _fma_plan(t, f, c).tiles, 2, c,
                                    device="cuda")
                row = [f"conv32 B{bsz} T{t} F{f} C{c}"]
                for name, lib in libs.items():
                    def run(lib=lib, res_on=True, pre_on=True):
                        err = lib.ddim_conv3x3(
                            x.data_ptr(), res.data_ptr() if res_on else None,
                            sc.data_ptr() if pre_on else None,
                            sh.data_ptr() if pre_on else None, w.data_ptr(),
                            add.data_ptr(), out.data_ptr(), stats.data_ptr(),
                            bsz, t, f, c, int(pre_on), 1, 0, st)
                        if err:
                            raise RuntimeError(f"ddim_conv3x3 fp32 {name}: "
                                               f"{err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                    if name == "full":
                        row.append("no_residual "
                                   f"{cuda_ms(lambda: run(res_on=False)):.4f}")
                        row.append("no_prologue "
                                   f"{cuda_ms(lambda: run(res_on=False, pre_on=False)):.4f}")
                wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                xn = x.view(bsz, t, f, c).permute(0, 3, 1, 2)
                row.append("cudnn_fp32 "
                           f"{cuda_ms(lambda: F.conv2d(xn, wl, padding=1)):.4f}")
                emit(" | ".join(row))
            for t, f, ci, co in TRAIN_UPS if "up32" in todo else ():
                x = rnd(bsz, t, f * ci)
                w = rnd(4, 4, ci, co, scale=(4 * ci) ** -0.5)
                bias, res = rnd(co), rnd(bsz, 2 * t, 2 * f * co)
                out = torch.empty_like(res)
                stats = torch.empty(bsz, _fma_plan(2 * t, 2 * f, co).tiles, 2,
                                    co, device="cuda")
                row = [f"up32 B{bsz} T{t} F{f} {ci}->{co}"]
                for name, lib in libs.items():
                    def run(lib=lib, res_on=True):
                        err = lib.ddim_conv_up(
                            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                            res.data_ptr() if res_on else None, out.data_ptr(),
                            stats.data_ptr(), bsz, t, f, ci, co, 0, st)
                        if err:
                            raise RuntimeError(f"ddim_conv_up fp32 {name}: "
                                               f"{err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                    if name == "full":
                        row.append("no_residual "
                                   f"{cuda_ms(lambda: run(res_on=False)):.4f}")
                xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
                wl = up_weight(w)
                lib_ms = cuda_ms(lambda: F.conv_transpose2d(xn, wl, stride=2,
                                                            padding=1))
                row.append(f"cudnn_fp32 {lib_ms:.4f}")
                emit(" | ".join(row))
            for t, f, ci, co in UPS_I8 if "upi8" in todo else ():
                x = rnd(bsz, t, f * ci).bfloat16()
                w = rnd(4, 4, ci, co, scale=(4 * ci) ** -0.5)
                wq = torch.randint(-127, 128, (4, 4, ci, co), generator=g,
                                   device="cuda").to(torch.int8)
                wq_t = wq.permute(0, 1, 3, 2).contiguous()
                s_w = w.abs().amax(dim=(0, 1, 2)) / 127
                bias, res = rnd(co), rnd(bsz, 2 * t, 2 * f * co).bfloat16()
                out = torch.empty_like(res)
                stats = torch.empty(bsz, -(-2 * t // 8) * -(-2 * f // 16), 2,
                                    co, device="cuda")
                row = [f"upi8 B{bsz} T{t} F{f} {ci}->{co}"]
                for name, lib in libs.items():
                    def run(lib=lib, res_on=True):
                        rp = res.data_ptr() if res_on else None
                        if hasattr(lib, "ddim_conv_up_int8"):
                            err = lib.ddim_conv_up_int8(
                                x.data_ptr(), wq_t.data_ptr(), s_w.data_ptr(),
                                bias.data_ptr(), rp, out.data_ptr(),
                                stats.data_ptr(), bsz, t, f, ci, co, 1, st)
                        else:
                            err = lib.ddim_conv_strided_int8(
                                x.data_ptr(), wq.data_ptr(), s_w.data_ptr(),
                                bias.data_ptr(), rp, out.data_ptr(),
                                stats.data_ptr(), 1, bsz, t, f, ci, co, 1, st)
                        if err:
                            raise RuntimeError(f"int8 up {name}: {err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                    if name == "full":
                        row.append("no_residual "
                                   f"{cuda_ms(lambda: run(res_on=False)):.4f}")
                wl = up_weight(w.bfloat16())
                xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
                lib_ms = cuda_ms(lambda: F.conv_transpose2d(xn, wl, stride=2,
                                                            padding=1))
                row.append(f"cudnn {lib_ms:.4f}")
                emit(" | ".join(row))
            for t, f, ci, co in DOWNS_I8 if "downi8" in todo else ():
                x = rnd(bsz, t, f * ci).bfloat16()
                w = rnd(4, 4, ci, co, scale=(16 * ci) ** -0.5)
                wq = torch.randint(-127, 128, (4, 4, ci, co), generator=g,
                                   device="cuda").to(torch.int8)
                wq_t = wq.permute(0, 1, 3, 2).contiguous()
                s_w = w.abs().amax(dim=(0, 1, 2)) / 127
                bias = rnd(co)
                out = torch.empty(bsz, t // 2, (f // 2) * co, device="cuda",
                                  dtype=torch.bfloat16)
                stats = torch.empty(bsz, -(-t // 16) * -(-f // 32), 2, co,
                                    device="cuda")
                row = [f"downi8 B{bsz} T{t} F{f} {ci}->{co}"]
                for name, lib in libs.items():
                    def run(lib=lib):
                        # the persistent kernel reads [4, 4, C_out, C_in]
                        # weights too
                        w = ((wq.data_ptr(), wq_t.data_ptr())
                             if down_int8_takes_t(lib) else (wq.data_ptr(),))
                        err = lib.ddim_conv_down_int8(
                            x.data_ptr(), *w, s_w.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), stats.data_ptr(), bsz, t, f, ci,
                            co, 1, st)
                        if err:
                            raise RuntimeError(f"int8 down {name}: {err}")
                    row.append(f"{name} {cuda_ms(run):.4f}")
                wl = w.bfloat16().permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
                lib_ms = cuda_ms(lambda: F.conv2d(xn, wl, stride=2, padding=1))
                row.append(f"cudnn {lib_ms:.4f}")
                emit(" | ".join(row))
            dw_shapes = (
                [("downdw32", 1, t, f, ci, co) for t, f, ci, co in TRAIN_DOWNS
                 if "downdw32" in todo]
                + [("dw32", 0, t, f, c, c) for t, f, c in TRAIN_STAGES
                   if "dw32" in todo]
                + [("updw32", 2, t, f, ci, co) for t, f, ci, co in TRAIN_UPS
                   if "updw32" in todo])
            for kind, mode, t, f, ci, co in dw_shapes:
                # g: the base grid's (mode 0), half x's (mode 1), 2T × 2F
                # (mode 2)
                tg, fg = {0: (t, f), 1: (t // 2, f // 2),
                          2: (2 * t, 2 * f)}[mode]
                x, gr = rnd(bsz, t, f * ci), rnd(bsz, tg, fg * co)
                k = 3 if mode == 0 else 4
                row = [f"{kind} B{bsz} T{t} F{f} {ci}->{co}"]
                for name, lib in libs.items():
                    splits = lib.ddim_conv_dw_splits(mode, bsz, t, f, ci, co,
                                                     0)
                    part = torch.empty(splits, k, k, ci, co, device="cuda")

                    def run(lib=lib, part=part, reduce=True, mode=mode):
                        err = lib.ddim_conv_dw(
                            x.data_ptr(), gr.data_ptr(), part.data_ptr(),
                            mode, bsz, t, f, ci, co, 0, st)
                        if err:
                            raise RuntimeError(f"{kind} {name}: {err}")
                        if reduce and part.shape[0] > 1:  # as the wrapper
                            part.sum(dim=0)
                    row.append(f"{name} {cuda_ms(run):.4f}")
                    if name == "full":
                        row.append("no_reduce "
                                   f"{cuda_ms(lambda: run(reduce=False)):.4f}")
                xn = x.view(bsz, t, f, ci).permute(0, 3, 1, 2)
                gn = gr.view(bsz, tg, fg, co).permute(0, 3, 1, 2)
                # mode 2: the weight gradient of the strided conv that maps
                # g to x
                inp, shape, gout, stride = {
                    0: (xn, (co, ci, 3, 3), gn, 1),
                    1: (xn, (co, ci, 4, 4), gn, 2),
                    2: (gn, (ci, co, 4, 4), xn, 2)}[mode]
                lib_ms = cuda_ms(lambda: conv2d_weight(
                    inp, shape, gout, stride=stride, padding=1))
                row.append(f"conv2d_weight_fp32 {lib_ms:.4f}")
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
            for t, f in HEAD_TAIL if todo & {"head", "tail"} else ():
                # chip_smoke.py's operands: Cin = Cout = 2, C0 = 32
                x = rnd(bsz, t, f * 2).bfloat16()
                wh, bh = rnd(3, 3, 2, 32, scale=0.2).bfloat16(), rnd(32)
                h, res = (rnd(bsz, t, f * 32).bfloat16(),
                          rnd(bsz, t, f * 32).bfloat16())
                wt = rnd(3, 3, 32, 2, scale=(9 * 32) ** -0.5).bfloat16()
                bt = rnd(2)
                out_h, out_t = torch.empty_like(h), torch.empty_like(x)
                # as many partials as either head kernel writes
                stats = torch.empty(bsz, _fma_plan(t, f, 32).tiles, 2, 32,
                                    device="cuda")
                for kind in sorted(todo & {"head", "tail"}):
                    row = [f"{kind} B{bsz} T{t} F{f}"]
                    for name, lib in libs.items():
                        def run(lib=lib, res_on=True, kind=kind):
                            if kind == "head":
                                err = lib.ddim_conv_head(
                                    x.data_ptr(), wh.data_ptr(), bh.data_ptr(),
                                    out_h.data_ptr(), stats.data_ptr(), bsz, t,
                                    f, 2, 32, 1, st)
                            else:
                                err = lib.ddim_conv_tail(
                                    h.data_ptr(),
                                    res.data_ptr() if res_on else None,
                                    wt.data_ptr(), bt.data_ptr(),
                                    out_t.data_ptr(), bsz, t, f, 32, 2, 1, st)
                            if err:
                                raise RuntimeError(f"ddim_conv_{kind} {name}: "
                                                   f"{err}")
                        row.append(f"{name} {cuda_ms(run):.4f}")
                        if name == "full" and kind == "tail":
                            row.append("no_residual "
                                       f"{cuda_ms(lambda: run(res_on=False)):.4f}")
                    if kind == "head":
                        wl = wh.permute(3, 2, 0, 1).contiguous(
                            memory_format=torch.channels_last)
                        xn = x.view(bsz, t, f, 2).permute(0, 3, 1, 2)
                    else:
                        wl = wt.permute(3, 2, 0, 1).contiguous(
                            memory_format=torch.channels_last)
                        xn = h.view(bsz, t, f, 32).permute(0, 3, 1, 2)
                    row.append("cudnn "
                               f"{cuda_ms(lambda: F.conv2d(xn, wl, padding=1)):.4f}")
                    emit(" | ".join(row))
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
