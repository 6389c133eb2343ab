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
   shape; in fp32 the head, in split TF32 on the bf16 head's persistent
   block, and the tail, still on its first, CUDA-core design, also beside
   one fp32 cuDNN call with TF32 off). Each bf16 case
   prints the kernel's and the twin's time from CUDA
   events (the card held busy while the host queues the timed calls, so
   they are the card's time, not the wrappers' Python), its bound (the
   larger of bytes moved / 3.35 TB/s and operations / the peak rate of the
   operand type), the time of the one PyTorch call that computes the bare
   conv (bf16, channels-last, cuDNN), the kernel / cuDNN ratio and the share
   of the bound; the redesigned conv3x3, up, down, int8-tap, head and tail
   kernels also show that the library's tile plan equals the Python model
   their wrappers size the statistics partials from, that bf16 takes the
   tensor-core variant at every production shape and at the head's and
   tail's small ragged one (``ddim_conv3x3_variant``,
   ``ddim_conv_up_variant``, ``ddim_conv_down_variant``,
   ``ddim_conv_head_variant``, ``ddim_conv_tail_variant``; 192->256 at
   f_out = 8 included) and fp32 the split-TF32 tensor-core one (conv3x3,
   up, down and, at the production shape, the head, whose small ragged
   shape takes the variant its plan picks, printed; the CUDA-core one for
   the tail), that the int8
   taps keep
   their 8 x 16 quantisation group (``ddim_conv3x3_int8_geometry``), and
   that the same call twice gives the same bits. Each kernel's sums at B = 2 in bf16 close the phase: kernel /
   cuDNN and the share of the bound;
   Then the int8-storage kernels (the storage modes of conv3x3, int8 input
   and residual with their scales and ``quant_out`` with and without
   statistics, at s0-s3; ``residual_affine_flat`` with int8 or float x and
   int8 s, ``quant_out`` on and off, at s0-s3, and as the float resblock
   tail, float x and s with statistics, at the six stages) and the int8
   strided taps
   (down 32->64, up 64->32, up 256->192) against their twins with the
   kernels' own groups, fp32 and bf16, B = 1 and 2: the share of int8
   outputs that differ (never by more than 1), scales, float outputs and
   statistics relative, the same call twice bit-equal, the storage conv's
   tile plan (the library's equal to the Python model, the tensor-core
   variant in bf16 at every storage shape and the CUDA-core one in fp32,
   tiles of whole 8 x 16 storage groups), the int8 up and down convs' plans
   (the library's equal to the Python model, one partial an 8 x 16 group;
   the down conv's grid persistent, its resident blocks on every SM) and
   their outputs bit-equal to the twin's, ``residual_affine_flat``'s plan
   (the library's equal to the Python model: persistent blocks over whole
   storage groups, one partial a block, fewer blocks than groups at
   s0-s2) and its int8 outputs, scales and float outputs bit-equal to the
   twin's, and for bf16 the kernel's, the
   twin's, the bound's and the one PyTorch call's time with kernel / cuDNN
   (``residual_affine_flat`` has none: no single call dequantises, adds and
   requantises per group; its lines give the share of the bound), then
   each kernel's B = 2 sum;
4. full-width forward of the audio.yml model (47,155,266 params, seed-made
   weights with non-zero final GroupNorm weights) at [1, 2, 8192, 256]: the
   production forward (bf16, int8 taps, as audio.yml ships it) and the
   float-tap fp32 and bf16 forwards against the fp32 plain route, with the
   launch counts of one forward each, and their times. Both bf16 forwards
   also run through the plain twins (``ops.twin_route``) with every wrapper
   call shadowed by its kernel on the same operands, which holds each kernel
   against its twin on the model's own activations and tells a kernel fault
   from int8 arithmetic noise; then route is held against route;
   [batch]: one forward at B = 2 per route (production, int8 storage, bf16
   and fp32 float taps, the plain route), every call of it held against the same call at
   B = 1 on each clip's slice of its operands: the port's kernels and its
   glue's channel sums must give the same bits (cuBLAS's GEMMs and cuDNN's
   transposed convs, which do not, are printed), each clip's whole forward
   at B = 1 against B = 2, and the statistics sums' kernel
   (``ops.sums``) against one torch.sum over the batch;
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

   Then the int8-storage configuration (audio.yml plus
   ``sampling.act_store: int8`` and ``sampling.strided_int8: true``, written
   to a temporary file): the full-width forward with its launch counts
   (40 storage conv3x3, 24 float, 32 ``residual_affine_flat``, down 4 + 1
   int8, up 3 + 2 int8, head, tail) against the fp32 plain route on both
   weight sets, every wrapper call shadowed by its kernel, its time beside
   the production route's; and the command line's 10-step last-only run at
   B = 2 on a checkpoint of the weights, its clips held against the same
   run through the twins;

7. the three weight-gradient kernels (``conv_dw_flat``,
   ``conv_down_dw_flat``, ``conv_up_dw_flat``) against their plain versions
   at every stage shape of the training geometry (microbatch 1 of
   [2, 1024, 256]), fp32 and bf16: agreement, the same kernel twice bit for
   bit, the kernel's and the plain version's time, the bound, and the one
   PyTorch call (``torch.nn.grad.conv2d_weight``; fp32 with TF32 off); each
   call's plan (``ddim_conv3x3_dw_plan``, ``ddim_conv_down_dw_plan``,
   ``ddim_conv_up_dw_plan``) equal to the Python model and to the
   library's partial count, and in fp32 split TF32 on the tensor cores, its
   bound that of three TF32 products an operation with the CUDA-core one
   beside it, each kernel's fp32 sums;
   then the float-tap conv3x3, down and up kernels in fp32 at the same
   shapes (``[train-kernels]``: the variants training runs, all three in
   split TF32 on the tensor cores, whose plans must equal the Python model
   and whose calls must give the same bits twice): agreement with the twin
   and its SNR, the kernel's, twin's and bound's time (split TF32, with the
   CUDA-core bound beside it) and one ``F.conv2d`` /
   ``F.conv_transpose2d`` call's (fp32, TF32 off);
   then ``[train-update]``: the train step's one-pass update
   (``ops.train_update``: clip, AdaBelief / AdamW, ``p + u`` and the EMA in
   four launches) at audio.yml's whole tree against its per-leaf twin
   (``training.train_step.update_plain``) from the same state and
   gradients: with the clip not engaged every parameter, moment and average
   bit-equal; with it engaged at grad_accum 2 each entry within
   TOL_GRAD_LEAF of its leaf's move plus one fp32 unit; ``grad_norm`` and
   ``update_norm`` within TOL_UPDATE_NORMS; the card's time by CUDA events
   beside its bound (10 fp32 values a parameter over 3.35 TB/s), the host's
   time a call and the per-leaf route's time;
8. grad: one microbatch forward + backward of the full audio.yml model
   (fp32, remat) on the non-zero-GN3 weights: the kernel route, the same
   through the plain twins with every wrapper call shadowed by its kernel,
   and the plain autograd route (cuDNN, TF32 off, deterministic); every
   parameter leaf's gradient of the kernel route held against the plain
   route; launch counts per microbatch required; ms per microbatch;
9. train, through the command line on a temporary folder of 16 seed-made
   ``.npy`` waveforms (14 train / 2 held out), audio.yml as shipped (batch
   14, ``grad_accum: 14``, fp32, remat) but for ``data.path``, ``n_iters``,
   ``snapshot_freq`` and ``validation_freq``: 3 steps → ``ckpt_1.npz`` and
   ``ckpt.npz``, finite logged losses, validation ran, the one-pass
   update's UPDATE_LAUNCHES launches a step counted; ``--resume_training``
   to step 5; the unbroken 5-step run, whose checkpoint must equal the
   resumed one bit for bit (parameters, optimizer state, EMA); ``--test``;
   ``--sample`` from that checkpoint; a 2-step ``model.dtype: bfloat16`` run
   whose losses track the fp32 run's; ms per optimizer step by CUDA events
   (the one-pass update's launches counted, fp32 and bf16 compute);
10. parallel: the command line with ``parallel: {dp: 2}`` in one plain
   process exits 1 with the mesh's refusal (one process is one rank); then
   two ranks on the one card in a gloo group (NCCL refuses two ranks on one
   device; the port's code is the same for both backends), spawned from
   this process: the sp = 2 forward (``parallel.sp.apply_model_sp``, each
   rank a [1, 2, 4096, 256] block) against the single-device kernel
   forward, fp32 float taps and production, with the conv3x3 launches of
   each shard (36 float + 28 int8 taps in production, every one on a block
   with one halo row a side; head, tail and transitions plain), the
   collectives of a forward and the host time in them, and the ms of an sp
   shard's forward, of the sp route on one rank and of the single-device
   forward; the runner's ``sample_last_only`` (4 DDIM steps, 2 clips,
   production) on sp = 2 and on dp = 2 against one device's run, rank 0
   alone writing the files; one fp32 dp = 2 training step (a microbatch
   [1, 2, 1024, 256] a rank, the launches of one microbatch each) against
   one device's grad_accum 2 step, leaf by leaf; in every training step of
   the ranks the one-pass update's UPDATE_LAUNCHES launches counted (none
   under ``reference_route``); one fp32 sp = 2 training
   step of audio.yml at [2, 2, 1024, 256] (each rank a [2, 2, 512, 256]
   block, the conv3x3 kernels' forward, dx and dW on haloed blocks of 514
   … 18 rows) against one device's step on the same injected draws (the
   loss, every leaf's gradient; the updates printed), the same step's
   kernel calls against their twins under ``reference_route(shadow=…)``
   with the calls per kernel, and its cost: CUDA-event and host ms beside
   one device's, the collectives and the host time inside them, the
   launches per shard.

Every failure raises and the script exits non-zero. The last three lines are
the card, the per-kernel JSON summary and ``{"ok": true, "device": {...}}``.
In the summary ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are sums
over the kernel's main-path shapes, each shape once: bf16 at B = 2 at the
sampling shapes for the forward kernels (for the storage conv its int8-in,
``quant_out`` mode, 32 of its 40 calls; for ``residual_affine_flat`` the
float resblock tail, bf16 x and s with statistics, at the six stages),
fp32 at B = 1 at the training shapes for the three weight-gradient kernels.
``launches`` counts the launches of the three command-line sampling runs of
phase 5 (the seven production kernels, ``residual_affine_flat`` among
them), of the int8-storage command-line run of phase 6 (the three
int8-storage kernels the main path does not run) or of the first
command-line training run of phase 9 (weight-gradient kernels); ``launches_train_path`` is every kernel's count in
that training run. It imports nothing of JAX.
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
# int8 storage and int8 strided taps vs their twins with the kernels' own
# groups. The strided kernels and residual_affine repeat the twin's
# arithmetic operation for operation (an H100 read them bit-equal at every
# shape); the storage conv sums its taps in another order, so an output on a
# rounding boundary may land on the next integer: at least this share of
# int8 outputs equal (an H100 read 0.999942 at the worst shape), none more
# than 1 apart, scales (a group's max|out| / 127) within 1e-4 relative (an
# H100 read 1.25e-5 at C = 128, where each output sums 1,152 products).
INT8_EQUAL_SHARE = 0.999
TOL_INT8_SCALES = 1e-4
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
# int8 68.4 dB (79.6 dB in the forward), down 79.8, up 89.1; the tensor-core
# tail 92.0 and head 95.1 dB (NVIDIA H100 80GB HBM3 at 700 W; the CUDA-core
# ones before them read 92.1 and 106.0); statistics within 2.3e-5 relative.
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
# The int8-storage configuration (act_store: int8, strided_int8: true, bf16,
# tap_int8 as shipped), each floor 2 dB under an H100's reading: forward vs
# the fp32 plain route 30.86 dB (non-zero GN3) and 43.86 dB (init weights;
# the JAX package's own guard of this route is 38 dB), vs its own twin route
# 32.27 dB, the command line's 10-step clips vs the twins 34.46 dB.
SNR_FWD_I8_GN3_DB = 28.8
SNR_FWD_I8_INIT_DB = 41.8
SNR_FWD_I8_TWIN_DB = 30.2
SNR_I8_CLI_TWIN_DB = 32.4
# Every call of that forward vs its twin: the storage conv read 76.9 dB at
# its worst call; the three kernels that repeat their twin's arithmetic read
# identical bits in every call (snr_db gives ~3000 dB for equal tensors), so
# their floor asks for the last bit.
SHADOW_FLOORS = {"conv3x3_flat_store": 75.2, "residual_affine_flat": 300.0,
                 "conv_down_flat_int8": 300.0, "conv_up_flat_int8": 300.0}
PARAMS_AUDIO_YML = 47_155_266
# Weight-gradient kernels vs their plain versions: the same operand values,
# fp32 accumulation on both sides, another summation order over up to
# 262,144 positions (an H100 read 1e-6 relative).
TOL_DW = 1e-4
# One fp32 microbatch, kernels against the twins call by call on the model's
# own activations and cotangents (an H100 read 123.8 dB at the worst call of
# the forward kernels and 132.3 dB of the weight-gradient kernels).
SHADOW_GRAD_FP32_DB = 100.0
# Every parameter leaf's gradient, kernel route against the plain autograd
# route: max|difference| over the leaf's max|gradient| (or, for a leaf whose
# own gradient is far below the largest, over 1e-3 of the largest). An H100
# read 6.6e-6 at the worst of the 388 leaves, 114.1 dB over all gradients.
TOL_GRAD_LEAF = 1e-4
# bf16 compute against fp32, the loss of the same optimizer steps (same
# data, timesteps and noise), relative (an H100 read 7.4e-5 from init
# weights, where the resblock branches are still multiplied by zero).
TOL_BF16_LOSS = 2e-2
# [parallel]: two gloo ranks on the one card (NCCL refuses two ranks on one
# device). The sp = 2 forward against the single-device kernel forward on
# the same weights and input. fp32 float taps: the plain transitions run
# cuDNN fp32 with TF32 off and the statistics are summed over the cropped
# blocks, the same arithmetic in another order (an H100 read 121.94 dB).
# Production (bf16, int8 taps): the int8 quantisation tiles fall otherwise
# on a haloed block, so each route carries its own int8 noise of 28 convs
# and the two differ by about both (an H100 read 25.69 dB); against the fp32
# float-tap output the sp route is held to the single-device production
# guard, SNR_FWD_PROD_GN3_DB.
SNR_SP_FP32_DB = 100.0
SNR_SP_PROD_DB = 23.7
# 4 DDIM steps of the runner on sp = 2 and on dp = 2 against one device's
# run of the same 2-clip batch, production config, each clip on its own, 2
# dB under an H100's reading: sp 27.19 dB (the int8 noise drawn anew, as
# above); dp 31.98 dB (a rank's batch of 1 against one device's batch of 2:
# one production forward of a clip alone against the 2-clip batch already
# reads 30.31-31.43 dB there, fp32 float taps 127.2 dB)
SNR_SP_CHAIN_DB = 25.2
SNR_DP_CHAIN_DB = 30.0
# one fp32 dp = 2 step (a microbatch a rank) against one device's
# grad_accum 2 step: every leaf of parameters, optimizer state and EMA
# within this of its leaf's scale (an H100 read all 1,557 leaves bit-equal)
TOL_DP_STEP = 1e-6
# one fp32 sp = 2 training step ([2, 2, 1024, 256], each rank a [2, 2, 512,
# 256] block) against one device's step on the same injected draws: the loss
# relative, and every leaf's gradient (the optimizer's first moment after one
# step, (1 - beta1)·g) and second moment held to the [grad] floor,
# TOL_GRAD_LEAF. The sp route runs head, tail and transitions as plain convs
# and sums its GroupNorm statistics and gradients in another order: the same
# arithmetic to within fp32 rounding (an H100 read the loss 5.0e-7 apart, the
# worst of 388 gradient leaves 3.3e-6 of its scale and of the second moments
# 9.8e-7). The parameters and the EMA are held entry by entry to TOL_GRAD_LEAF
# of their leaf's move plus one fp32 unit of the value (``_move_gaps``): step
# 0's learning rate is the warm-up's 3e-7, so a weight moves by a few of its
# units or less and an update that differs in its last bits lands one unit away
# (an H100 read 488 of 47,155,266 parameter entries that needed the unit, none
# beyond it, the worst 0.50 of its leaf's move at a stage-4 conv weight whose
# entries move by one unit at most; the EMA none). At most this share of the
# entries may need the unit:
TOL_SP_ULP_SHARE = 1e-4
TOL_SP_LOSS = 1e-5

# The one-pass update against the per-leaf route: the norms (the clip's,
# ``grad_norm``, ``update_norm``) sum in another order than torch's
# reductions, within this of each other.
TOL_UPDATE_NORMS = 1e-6
# the one-pass update's launches a step (ops.train_update)
UPDATE_LAUNCHES = 4
# Cycles the card sleeps before the update's timed calls: the wrapper's
# host side (tables, views, the state's trees) takes a few ms a call.
PREFILL_UPDATE_CYCLES = 400_000_000

# Published H100 SXM peaks: HBM bytes/s and dense operations/s by operand type
# (fp32 outside the tensor cores; "tf32x3": the split-TF32 fp32 conv3x3, up
# and down convs and the three weight gradients, three TF32 tensor-core
# products an fp32 one, 495 / 3 TFLOP/s).
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
            "tf32x3": 495e12 / 3}
VARIANT_NAMES = {0: "fma", 1: "mma", 2: "tf32x3"}
# the wrappers whose fp32 calls run split TF32 on the tensor cores (the
# head where its plan takes the shape: audio.yml's)
TF32_KERNELS = ("conv3x3_flat", "conv_up_flat", "conv_down_flat",
                "conv_head_flat")
HEAD_TAIL_KERNELS = ("conv_head_flat", "conv_tail_flat")

# Production stage shapes at [1, 2, 8192, 256] (T, F, C), and transitions
# (T_in, F_in, C_in, C_out) of the down path.
STAGES = [(8192, 256, 32), (4096, 128, 64), (2048, 64, 96), (1024, 32, 128),
          (512, 16, 192), (256, 8, 256)]
INT8_STAGES = STAGES[:3]
DOWNS = [(8192, 256, 32, 64), (4096, 128, 64, 96), (2048, 64, 96, 128),
         (1024, 32, 128, 192), (512, 16, 192, 256)]
HEAD_TAIL = [(8192, 256, True), (40, 24, False)]  # (T, F, production shape)

# Training geometry: stage shapes (T, F, C) of one microbatch [1, 2, 1024, 256]
TRAIN_STAGES = [(1024, 256, 32), (512, 128, 64), (256, 64, 96), (128, 32, 128),
                (64, 16, 192), (32, 8, 256)]
TRAIN_DOWNS = [(t, f, c, c2) for (t, f, c), (_, _, c2)
               in zip(TRAIN_STAGES, TRAIN_STAGES[1:])]
# launches of one training microbatch (forward, remat recompute, backward):
# 64 resblock convs + padded head + tail forward, 64 recomputed, dx for all
# but the head (its input is data); dx of a down conv is the up kernel and
# the reverse
INT8_STORE_KERNELS = ("conv3x3_flat_store", "residual_affine_flat",
                      "conv_down_flat_int8", "conv_up_flat_int8")
PER_MICROBATCH = {"conv3x3_flat": 66 + 64 + 65, "conv3x3_flat_int8": 0,
                  "conv_head_flat": 0, "conv_tail_flat": 0,
                  "conv_down_flat": 5 + 5, "conv_up_flat": 5 + 5,
                  "conv_dw_flat": 66, "conv_down_dw_flat": 5,
                  "conv_up_dw_flat": 5, **dict.fromkeys(INT8_STORE_KERNELS, 0)}
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
    "conv_dw_flat": (CSRC + "conv_dw.cu", "ddim_audio_tpu/ops/flat_grad.py:51"),
    "conv_down_dw_flat": (CSRC + "conv_dw.cu",
                          "ddim_audio_tpu/ops/flat_grad.py:334"),
    "conv_up_dw_flat": (CSRC + "conv_dw.cu",
                        "ddim_audio_tpu/ops/flat_grad.py:437"),
    "conv3x3_flat_store": (CSRC + "conv3x3_store.cu",
                           PALLAS + "conv_flat.py:283"),
    "residual_affine_flat": (CSRC + "residual_affine.cu",
                             PALLAS + "conv_flat.py:484"),
    "conv_down_flat_int8": (CSRC + "conv_strided_int8.cu",
                            PALLAS + "conv_strided.py:230"),
    "conv_up_flat_int8": (CSRC + "conv_strided_int8.cu",
                          PALLAS + "conv_strided.py:541"),
}
# launches of one forward: float-tap route and production route (each of
# the 32 resblocks' tails and next statistics one residual_affine_flat)
PER_FORWARD_FLOAT = {"conv3x3_flat": 64, "conv3x3_flat_int8": 0,
                     "conv_head_flat": 1, "conv_tail_flat": 1,
                     "conv_down_flat": 5, "conv_up_flat": 5,
                     **dict.fromkeys(INT8_STORE_KERNELS, 0),
                     "residual_affine_flat": 32}
PER_FORWARD_PROD = dict(PER_FORWARD_FLOAT, conv3x3_flat=36,
                        conv3x3_flat_int8=28)
# the int8-storage configuration (audio.yml + act_store: int8 +
# strided_int8: true): s0-s3 store int8 between their kernels (40 convs, 20
# int8 tails, float taps there), s4-s5 float taps (24 convs, 12 float
# tails), int8 taps in down 32->64, up 64->32 and up 256->192
PER_FORWARD_I8 = dict(PER_FORWARD_FLOAT, conv3x3_flat=24, conv3x3_flat_store=40,
                      conv_down_flat=4, conv_down_flat_int8=1, conv_up_flat=3,
                      conv_up_flat_int8=2)
DW_KERNELS = ("conv_dw_flat", "conv_down_dw_flat", "conv_up_dw_flat")
# one sp shard's forward ([parallel]): the resblock convs on haloed blocks;
# the head, the tail and the transitions run as plain convs there
PER_SHARD_FLOAT = dict(PER_FORWARD_FLOAT, conv_head_flat=0, conv_tail_flat=0,
                       conv_down_flat=0, conv_up_flat=0)
PER_SHARD_PROD = dict(PER_SHARD_FLOAT, conv3x3_flat=36, conv3x3_flat_int8=28)
# one sp shard's training step ([parallel]): the 64 resblock convs on haloed
# blocks forward, again in the remat recompute and as dx, and their weight
# gradients; head, tail and transitions plain
PER_SHARD_TRAIN = dict(PER_MICROBATCH, conv3x3_flat=3 * 64, conv_dw_flat=64,
                       conv_down_flat=0, conv_up_flat=0, conv_down_dw_flat=0,
                       conv_up_dw_flat=0)
# the kernels whose per-clip result must not depend on the batch ([batch]):
# every wrapper of the sampling forwards (int8 storage included) and the
# glue's channel sums
BATCH_INVARIANT = ("conv3x3_flat", "conv3x3_flat_int8", "conv_head_flat",
                   "conv_tail_flat", "conv_down_flat", "conv_up_flat",
                   "conv3x3_flat_store", "residual_affine_flat",
                   "conv_down_flat_int8", "conv_up_flat_int8", "channel_sums")
# the statistics sums' kernel against an fp64 sum of the same fp32 / bf16
# values, max|difference| over the largest sum of its row
TOL_BATCH_SUMS = 1e-5


def forward_counts() -> dict:
    """Launch counts of the six forward kernels (the sampling phases check
    these; the weight-gradient kernels never run there)."""
    from ddim_audio_tpu_torch.ops import launch_counts

    counts = launch_counts()
    for name in DW_KERNELS:
        require(counts.pop(name) == 0, f"{name} launched on a sampling path")
    return counts


def plain_cfg(cfg):
    """cfg on the plain route: every layer in PyTorch (cuDNN convs), no
    kernel (``apply_model`` with ``conv_impl: xla``)."""
    import dataclasses

    return dataclasses.replace(cfg, conv_impl="xla")


def log(msg: str) -> None:
    print(msg, flush=True)


class Fail(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise Fail(msg)


# Cycles the card sleeps before a kernel's timed calls (~25-35 ms): the host
# queues the calls meanwhile, so the events time the card alone, not a
# wrapper's Python (40-100 us a call for the head and tail, more than their
# kernels take).
PREFILL_CYCLES = 50_000_000


def cuda_time(fn, n: int = 10, warmup: int = 2, prefill: bool = False) -> float:
    """Mean ms per call from CUDA events over n calls after warmup; with
    ``prefill`` the card first sleeps while the host queues the calls, so
    the mean is the card's time per call (the kernels' tables), else the
    pace at which the host and the card together get through them (the
    forwards and microbatches)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if prefill:
        torch.cuda._sleep(PREFILL_CYCLES)
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

    def check(self, tag, want_calls, floor_db=None):
        calls = {name: e[0] for name, e in self.seen.items()}
        want_calls = {k: v for k, v in want_calls.items() if v}
        require(calls == want_calls, f"{tag}: shadowed calls {calls} != "
                f"{want_calls}")
        for name, (n, snr, srel) in self.seen.items():
            floor = floor_db or SHADOW_FLOORS.get(name) or (
                SHADOW_INT8_DB if name.endswith("int8") else SHADOW_FLOAT_DB)
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


def _kernel_cases(torch, bsz, stages=STAGES, downs=DOWNS,
                  head_tail=HEAD_TAIL):
    """One dict per case at batch bsz with every fusion of the main path on
    (at the sampling shapes unless ``stages``, ``downs`` and ``head_tail``
    say otherwise):
    name, label, prod (a production shape: timed and summed), kernel, twin,
    make(dtype) -> (args, kwargs), lib(args, kwargs) -> the one-PyTorch-call
    conv on the same operands, io(args, kwargs, outs) -> the tensors the
    function must move, ops (operations of the taps), int8."""
    import torch.nn.functional as F

    from ddim_audio_tpu_torch.ops.conv_flat import (
        INT8_KERNEL_HALO, INT8_KERNEL_TILE, conv3x3_flat, conv3x3_flat_int8,
        conv3x3_flat_int8_plain, conv3x3_flat_plain, int8_weights_co_ci,
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
    for t, f, c in stages:
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
                          io=io_conv, ops=ops, int8=False,
                          plan=("conv3x3", (t, f, c))))
        if (t, f, c) not in INT8_STAGES:
            continue
        wq, s_w = quantize_conv_weights_int8(w)
        wq_t = int8_weights_co_ci(wq)  # as prepare_params lays it out

        def make8(dt, x=x, wq=wq, s_w=s_w, wq_t=wq_t, res=res, fused=fused):
            return (x.to(dt), wq, s_w), dict(fused, residual=res.to(dt),
                                             wq_t=wq_t)

        def twin8(*pos, wq_t=None, **kw):  # the kernel's own group; HWIO wq
            return conv3x3_flat_int8_plain(
                *pos, q_tile=INT8_KERNEL_TILE, q_halo=INT8_KERNEL_HALO, **kw)
        cases.append(dict(name="conv3x3_flat_int8", label=f"T{t} F{f} C{c}",
                          prod=True, kernel=conv3x3_flat_int8, twin=twin8,
                          make=make8, lib=lib, io=io_conv, ops=ops, int8=True,
                          plan=("conv3x3_int8", (t, f, c))))
    for t, f, ci, co in downs:
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
                          int8=False, plan=("conv_down", (t, f, ci, co))))
    for t, f, co, ci in downs:  # up runs each transition in reverse
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
                          ops=2.0 * 4 * ci * co * t * f * bsz, int8=False,
                          plan=("conv_up", (t // 2, f // 2, ci, co))))
    for t, f, prod in head_tail:
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
                          io=io_conv, ops=ops, int8=False,
                          plan=("conv_head", (t, f, cin, c0))))
        cases.append(dict(name="conv_tail_flat", label=f"T{t} F{f} 32->2",
                          prod=prod, kernel=conv_tail_flat,
                          twin=conv_tail_flat_plain, make=make_t, lib=lib_t,
                          io=io_conv, ops=ops, int8=False,
                          plan=("conv_tail", (t, f, c0, cin))))
    return cases


def check_plan(case, bsz, bf16) -> str:
    """The redesigned kernels (conv3x3_flat, conv_up_flat, conv_down_flat,
    conv3x3_flat_int8, conv_head_flat, conv_tail_flat): the library's tile
    plan equals the Python model the wrapper sizes its partials from, and
    the variant is the tensor-core kernel in bf16 (in fp32 the split-TF32
    one for conv3x3, up, down and the head at its production shape, the
    head's small ragged shape whichever its plan picks, the CUDA-core one
    for the tail;
    the int8 taps run on the tensor cores in both, over the quantisation
    group the geometry query reports, 8 × 16 with a 1-position halo).
    Returns the plan's note for the kernel's line."""
    from ddim_audio_tpu_torch.ops import _cuda, tile_plan

    kind, shape = case["plan"]
    lib = _cuda.kernels()
    model = getattr(tile_plan, f"{kind}_plan")(*shape, bool(bf16), bsz)
    got = tile_plan.library_plan(getattr(lib, f"ddim_{kind}_plan"), *shape,
                                 bf16, bsz)
    tag = f"{case['name']} B{bsz} {case['label']} bf16={bf16}"
    require(got == model, f"{tag}: library plan {got} != Python model {model}")
    if case["int8"]:
        group = tuple(lib.ddim_conv3x3_int8_geometry(i) for i in range(4))
        require(group == (8, 16, 1, 1), f"{tag}: quantisation group {group}")
        variant, want = got.variant, tile_plan.VARIANT_MMA
    else:
        variant = getattr(lib, f"ddim_{kind}_variant")(*shape, bf16)
        want = (tile_plan.VARIANT_MMA if bf16 else tile_plan.VARIANT_TF32
                if case["name"] in TF32_KERNELS else tile_plan.VARIANT_FMA)
        if case["name"] == "conv_head_flat" and not bf16 and not case["prod"]:
            want = model.variant  # the small ragged shape: the plan's pick
    require(variant == want == got.variant,
            f"{tag}: variant {variant}, want {want}")
    return (f" | {VARIANT_NAMES[variant]} tile {got.tile_t}x{got.tile_f}"
            f" split {got.split}/{got.groups}")


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
                if "plan" in case:
                    line += check_plan(case, bsz, int(dt == "bf16"))
                    again = as_tuple(kern(*pos, **kw))
                    require(all(torch.equal(a, b) for a, b in zip(outs, again)),
                            f"{name} {label} {dt}: two calls differ")
                    line += " twice bit-equal"
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
                ms = cuda_time(lambda: kern(*pos, **kw), prefill=True)
                plain_ms = cuda_time(lambda: twin(*pos, **kw), n=5, warmup=1,
                                      prefill=True)
                kind = ("int8" if case["int8"] else "tf32x3"
                        if dt == "fp32" and name in TF32_KERNELS else dt)
                bnd, by = bound_ms(case["io"](pos, kw, outs), case["ops"], kind)
                line += (f" | kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, bound "
                         f"{bnd:.3f} ms ({by})")
                if dtype == torch.bfloat16:
                    lib_ms = cuda_time(case["lib"](pos, kw), prefill=True)
                    line += (f", cuDNN bf16 conv {lib_ms:.3f} ms: kernel / "
                             f"cuDNN {ms / lib_ms:.2f}x, bound / kernel "
                             f"{bnd / ms:.1%} ({by})")
                elif name in HEAD_TAIL_KERNELS:  # the head split TF32
                    lib32 = cuda_time(case["lib"](pos, kw), prefill=True)
                    line += (f", cuDNN fp32 conv (TF32 off) {lib32:.3f} ms: "
                             f"kernel / cuDNN {ms / lib32:.2f}x, bound / "
                             f"kernel {bnd / ms:.1%} ({by})")
                if dtype == torch.bfloat16 and bsz == 2:  # the main path
                    entry["ms"] += ms
                    entry["plain_ms"] += plain_ms
                    entry["bound_ms"] += bnd
                    entry["library_ms"] += lib_ms
                    entry["_bytes" if by == "bytes" else "_ops"] += bnd
                log(line)
    for name, entry in summary.items():
        entry["bound_by"] = ("bytes" if entry.pop("_bytes") >= entry.pop("_ops")
                             else "operations")
        log(f"[kernels] sum B2 bf16 {name:17s} kernel {entry['ms']:.3f} ms, "
            f"cuDNN {entry['library_ms']:.3f} ms: "
            f"{entry['ms'] / entry['library_ms']:.2f}x; bound / kernel "
            f"{entry['bound_ms'] / entry['ms']:.1%} ({entry['bound_by']})")


# int8 storage and int8 strided taps: the stages that store int8 (s0-s3) and
# the transitions that run int8 taps at audio.yml, (T_in, F_in, C_in, C_out)
STORE_STAGES = STAGES[:4]
DOWNS_I8 = [DOWNS[0]]
UPS_I8 = [(4096, 128, 64, 32), (256, 8, 256, 192)]


def _int8_cases(torch, bsz):
    """The four int8-storage kernels at every production shape of their
    path, and ``residual_affine_flat`` as the float resblock tail at the six
    stages: dicts of name, label, kernel, twin, make(dtype) -> (args, kwargs),
    layout (what each output is: "q" int8, "scales", "out" float, "stats"),
    io, ops, kind (the operand type of the operations), lib (the one PyTorch
    call, or None) and timed (the shape's mode the summary sums)."""
    import torch.nn.functional as F

    from ddim_audio_tpu_torch.ops.conv_flat import (
        conv3x3_flat_plain, conv3x3_flat_store, int8_weights_co_ci,
        quantize_store)
    from ddim_audio_tpu_torch.ops.conv_strided import (
        conv_down_flat_int8, conv_down_flat_int8_plain, conv_up_flat_int8,
        conv_up_flat_int8_plain, quantize_strided_weights_int8,
        up_weight_to_torch)
    from ddim_audio_tpu_torch.ops.residual_affine import (
        residual_affine_flat, residual_affine_flat_plain)

    g = torch.Generator(device="cuda").manual_seed(4)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def io_of(pos, kw, outs):
        flat = [v for p in pos for v in (p if isinstance(p, tuple) else (p,))]
        return [*flat, *[v for v in kw.values() if isinstance(v, torch.Tensor)],
                *(kw.get("pre") or ()), *outs]

    cases = []
    for t, f, c in STORE_STAGES:
        x, w, res = rnd(bsz, t, f * c), rnd(3, 3, c, c, scale=(9 * c) ** -0.5), \
            rnd(bsz, t, f * c)
        q, sc = quantize_store(x.view(bsz, t, f, c))
        rq, rsc = quantize_store(res.view(bsz, t, f, c))
        pre, add = (1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c)), rnd(bsz, c)
        fused = dict(c=c, pre=pre, add=add, pre_silu=True, post_silu=True)
        modes = [  # (label, x, kwargs, layout, timed)
            ("float in, quant_out, stats", None, dict(quant_out=True,
                                                      want_stats=True),
             ("q", "scales", "stats", "stats"), False),
            ("int8 in, quant_out, stats", q, dict(in_scales=sc, quant_out=True,
                                                  want_stats=True),
             ("q", "scales", "stats", "stats"), True),
            ("int8 in, quant_out", q, dict(in_scales=sc, quant_out=True),
             ("q", "scales"), False),
            ("float in, int8 residual, stats", None, dict(
                residual=rq, res_scales=rsc, want_stats=True),
             ("out", "stats", "stats"), False),
        ]
        for label, xin, extra, layout, timed in modes:
            scaled = int(xin is not None) + int("res_scales" in extra)

            def make(dt, x=x, xin=xin, w=w, fused=fused, extra=extra):
                return ((x.to(dt) if xin is None else xin, w.to(dt)),
                        dict(fused, **extra))

            def lib(pos, kw, x=x, w=w, c=c):
                xl, wl = x.to(pos[1].dtype), _oihw(w.to(pos[1].dtype))
                return lambda: F.conv2d(_nchw(xl, c), wl, padding=1)
            cases.append(dict(
                name="conv3x3_flat_store", label=f"T{t} F{f} C{c} {label}",
                kernel=conv3x3_flat_store, twin=conv3x3_flat_plain, make=make,
                layout=layout, io=io_of, lib=lib, kind="bf16", timed=timed,
                ops=2.0 * 9 * c * c * t * f * bsz,
                store_plan=(t, f, c, scaled)))
        s8, ssc = quantize_store(rnd(bsz, t, f, c))
        aff = (1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c))
        for xk in ("int8", "float"):
            for qo in (True, False):
                def make(dt, xk=xk, qo=qo, x=x, q=q, sc=sc, s8=s8, ssc=ssc,
                         aff=aff, c=c):
                    xin, xs = (q, sc) if xk == "int8" else (x.to(dt), None)
                    return ((xin, s8, aff), dict(
                        c=c, x_scales=xs, s_scales=ssc, quant_out=qo,
                        want_stats=True, out_dtype=dt))
                cases.append(dict(
                    name="residual_affine_flat",
                    label=f"T{t} F{f} C{c} {xk} x, int8 s, quant_out {qo}",
                    kernel=residual_affine_flat,
                    twin=residual_affine_flat_plain, make=make,
                    layout=(("q", "scales") if qo else ("out",))
                    + ("stats", "stats"), io=io_of, lib=None, kind="fp32",
                    timed=False, ops=4.0 * bsz * t * f * c,
                    resaff_plan=(t, f, c)))
    for t, f, c in STAGES:  # the float resblock tail of the sampling forward
        x, s = rnd(bsz, t, f * c), rnd(bsz, t, f * c, scale=3.0)
        aff = (1 + 0.1 * rnd(bsz, c), 0.1 * rnd(bsz, c))

        def make(dt, x=x, s=s, aff=aff, c=c):
            return ((x.to(dt), s.to(dt), aff),
                    dict(c=c, want_stats=True, out_dtype=dt))
        cases.append(dict(
            name="residual_affine_flat",
            label=f"T{t} F{f} C{c} float tail, stats",
            kernel=residual_affine_flat, twin=residual_affine_flat_plain,
            make=make, layout=("out", "stats", "stats"), io=io_of, lib=None,
            kind="fp32", timed=True, ops=4.0 * bsz * t * f * c,
            resaff_plan=(t, f, c)))
    for up, shapes in ((False, DOWNS_I8), (True, UPS_I8)):
        for t, f, ci, co in shapes:
            x = rnd(bsz, t, f * ci)
            w = rnd(4, 4, ci, co, scale=((4 if up else 16) * ci) ** -0.5)
            wq, ws = quantize_strided_weights_int8(w)
            b = rnd(co)
            res = rnd(bsz, 2 * t, 2 * f * co) if up else None

            wq_t = int8_weights_co_ci(wq)

            def make(dt, x=x, wq=wq, ws=ws, b=b, res=res, ci=ci, co=co,
                     up=up, wq_t=wq_t):
                # the weights as prepare_params lays them out
                kw = dict(c_in=ci, c_out=co, want_stats=True, wq_t=wq_t)
                if up:
                    kw.update(residual=res.to(dt))
                return (x.to(dt), wq, ws, b), kw

            def twin_of(plain):
                def twin(*pos, wq_t=None, **kw):  # the twin reads HWIO wq
                    return plain(*pos, **kw)
                return twin

            def lib(pos, kw, w=w, ci=ci, up=up):
                if up:
                    wl = up_weight_to_torch(w.to(pos[0].dtype)).contiguous(
                        memory_format=torch.channels_last)
                    return lambda: F.conv_transpose2d(_nchw(pos[0], ci), wl,
                                                      stride=2, padding=1)
                wl = _oihw(w.to(pos[0].dtype))
                return lambda: F.conv2d(_nchw(pos[0], ci), wl, stride=2,
                                        padding=1)
            to, fo = (2 * t, 2 * f) if up else (t // 2, f // 2)
            cases.append(dict(
                name="conv_up_flat_int8" if up else "conv_down_flat_int8",
                label=f"T{t} F{f} {ci}->{co}",
                kernel=conv_up_flat_int8 if up else conv_down_flat_int8,
                twin=twin_of(conv_up_flat_int8_plain if up
                             else conv_down_flat_int8_plain),
                make=make, layout=("out", "stats", "stats"), io=io_of, lib=lib,
                kind="int8", timed=True,
                ops=2.0 * (4 if up else 16) * ci * co * to * fo * bsz,
                strided_plan=(up, (t, f, ci, co))))
    return cases


def _compare(layout, outs, refs):
    """(int8 share equal, int8 max |diff|, float rel, scales rel, stats rel)
    of a kernel's outputs against its twin's."""
    eq, mx, frel, srel, strel = 1.0, 0, 0.0, 0.0, 0.0
    for kind, o, r in zip(layout, outs, refs):
        if kind == "q":
            d = (o.int() - r.int()).abs()
            eq, mx = (d == 0).float().mean().item(), int(d.max().item())
        elif kind == "out":
            frel = rel_err(o, r)[1]
        elif kind == "scales":
            srel = ((o - r).abs() / r.abs()).max().item()
        else:
            strel = max(strel, rel_err(o, r)[1])
    return eq, mx, frel, srel, strel


def check_store_plan(case, bsz, bf16) -> str:
    """The storage conv: the library's tile plan equals the Python model
    the wrapper sizes its partials from, the variant is the tensor-core
    kernel in bf16 (the CUDA-core one in fp32), every tile is a whole number
    of storage groups and the storage group is 8 × 16
    (``ddim_store_geometry``). Returns the plan's note for the line."""
    from ddim_audio_tpu_torch.ops import _cuda, tile_plan

    t, f, c, scaled = case["store_plan"]
    lib = _cuda.kernels()
    model = tile_plan.conv3x3_store_plan(t, f, c, bool(bf16), bsz, scaled)
    got = tile_plan.library_plan(lib.ddim_conv3x3_store_plan, t, f, c, bf16,
                                 bsz, scaled)
    tag = f"{case['name']} B{bsz} {case['label']} bf16={bf16}"
    require(got == model, f"{tag}: library plan {got} != Python model {model}")
    group = tuple(lib.ddim_store_geometry(i) for i in range(2))
    require(group == (8, 16), f"{tag}: storage group {group}")
    want = tile_plan.VARIANT_MMA if bf16 else tile_plan.VARIANT_FMA
    require(got.variant == want, f"{tag}: variant {got.variant}, want {want}")
    require(got.tile_t % 8 == 0 and got.tile_f == 16,
            f"{tag}: tile {got.tile_t}x{got.tile_f} is no union of groups")
    return (f" | {'mma' if got.variant else 'fma'} tile {got.tile_t}x"
            f"{got.tile_f} split {got.split}/{got.groups}")


def check_strided_int8_plan(case, bsz, bf16, outs, refs) -> str:
    """The persistent int8-tap up and down convs: the library's tile plan
    equals the Python model the wrapper sizes its partials from (one a
    quantisation group of 8 × 16 outputs), the tensor-core variant, for the
    down conv a persistent grid of its resident blocks on every SM (fewer
    blocks than groups), and the output equals the twin's bit for bit.
    Returns the note for the line."""
    import torch

    from ddim_audio_tpu_torch.ops import _cuda, tile_plan

    up, shape = case["strided_plan"]
    lib = _cuda.kernels()
    kind = "up" if up else "down"
    model = getattr(tile_plan, f"conv_{kind}_int8_plan")(*shape, bool(bf16),
                                                         bsz)
    got = tile_plan.library_plan(getattr(lib, f"ddim_conv_{kind}_int8_plan"),
                                 *shape, bf16, bsz)
    tag = f"{case['name']} B{bsz} {case['label']} bf16={bf16}"
    require(got == model, f"{tag}: library plan {got} != Python model {model}")
    require(got.variant == tile_plan.VARIANT_MMA and got[1:3] == (8, 16),
            f"{tag}: plan {got}")
    require(torch.equal(outs[0], refs[0]), f"{tag}: output differs from the "
            "twin's")
    note = ""
    if not up:
        per_sm = tile_plan.down_int8_resident(got.smem)
        require(got.grid == per_sm * tile_plan.SMS // got.split
                and got.grid < bsz * got.tiles,
                f"{tag}: grid {got.grid} is not persistent ({per_sm} blocks "
                f"an SM, {bsz * got.tiles} groups)")
        note = (f" persistent grid {got.grid} ({per_sm} an SM) over "
                f"{bsz * got.tiles} groups,")
    return (f" | mma group {got.tile_t}x{got.tile_f} z {got.split},{note} "
            "bit-equal to the twin")


def check_resaff_plan(case, bsz, pos, outs, refs) -> str:
    """residual_affine_flat: the library's plan equals the Python model the
    wrapper sizes its partials from (persistent blocks over whole 8 × 16
    storage groups, one partial a block; at s0-s2 fewer blocks than groups,
    so that each walks several), and its int8 outputs, scales and float
    outputs equal the twin's bit for bit. Returns the note for the line."""
    import torch

    from ddim_audio_tpu_torch.ops import _cuda, tile_plan

    t, f, c = case["resaff_plan"]
    kinds = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    shape = (t, f, c, kinds[pos[0].dtype], kinds[pos[1].dtype])
    model = tile_plan.residual_affine_plan(*shape, bsz)
    got = tile_plan.library_plan(_cuda.kernels().ddim_residual_affine_plan,
                                 *shape, bsz)
    tag = f"{case['name']} B{bsz} {case['label']} x kind {shape[3]}"
    require(got == model, f"{tag}: library plan {got} != Python model {model}")
    groups = tile_plan.store_tiles(t, f)
    require(got.variant == tile_plan.VARIANT_FMA and got[1:3] == (8, 16)
            and got.tiles == got.grid <= groups
            and (t < 2048 or got.grid < groups),
            f"{tag}: plan {got} is not persistent over {groups} groups")
    n = sum(k != "stats" for k in case["layout"])
    require(all(torch.equal(o, r) for o, r in zip(outs[:n], refs[:n])),
            f"{tag}: outputs differ from the twin's")
    return (f" | persistent grid {got.grid} x {bsz} x {got.groups} over "
            f"{groups} groups a sample, bit-equal to the twin")


def phase_int8_kernels(summary):
    """The int8-storage kernels (conv3x3 storage modes, residual_affine, the
    latter also as the float resblock tail) and the int8 strided taps against their twins (the kernels' own groups) at
    every production shape of their path, B = 1 and 2, fp32 and bf16: int8
    outputs equal or off by one (the share that differs), scales, float
    outputs and statistics relative, the same call twice bit-equal; bf16
    cases timed against the twin, the bound and the one PyTorch call."""
    import torch

    def as_tuple(r):
        return r if isinstance(r, tuple) else (r,)

    for bsz in (1, 2):
        for case in _int8_cases(torch, bsz):
            name, label = case["name"], f"B{bsz} " + case["label"]
            kern, twin = case["kernel"], case["twin"]
            entry = summary.setdefault(name, {
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "library_ms": 0.0, "_bytes": 0.0,
                "_ops": 0.0})
            for dtype, dt in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
                pos, kw = case["make"](dtype)
                outs = as_tuple(kern(*pos, **kw))
                again = as_tuple(kern(*pos, **kw))
                refs = as_tuple(twin(*pos, **kw))
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(outs, again))
                eq, mx, frel, srel, strel = _compare(case["layout"], outs, refs)
                err = max(rel_err(o, r)[0] for k, o, r in
                          zip(case["layout"], outs, refs) if k in ("q", "out"))
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                line = (f"[int8] {name:20s} {label:48s} {dt} int8 equal "
                        f"{eq:.6f} (differ {1 - eq:.2e}, max {mx}) | out rel "
                        f"{frel:.2e} | scales rel {srel:.2e} | stats rel "
                        f"{strel:.2e} | twice bit-equal {same}")
                if "store_plan" in case:
                    line += check_store_plan(case, bsz, int(dt == "bf16"))
                if "strided_plan" in case:
                    line += check_strided_int8_plan(case, bsz,
                                                    int(dt == "bf16"),
                                               outs, refs)
                if "resaff_plan" in case:
                    line += check_resaff_plan(case, bsz, pos, outs, refs)
                require(same, f"{name} {label} {dt}: two runs differ")
                require(mx <= 1 and eq >= INT8_EQUAL_SHARE,
                        f"{name} {label} {dt}: int8 outputs equal {eq:.6f}, "
                        f"max |diff| {mx}")
                tol = TOL_FP32 if dt == "fp32" else TOL_BF16
                require(frel <= tol, f"{name} {label} {dt}: out rel {frel:.2e}")
                require(srel <= TOL_INT8_SCALES, f"{name} {label} {dt}: scales "
                        f"rel {srel:.2e} > {TOL_INT8_SCALES}")
                require(strel <= TOL_STATS, f"{name} {label} {dt}: stats rel "
                        f"{strel:.2e} > {TOL_STATS}")
                if dtype != torch.bfloat16 or not (case["timed"] or bsz == 1):
                    log(line)
                    continue
                ms = cuda_time(lambda: kern(*pos, **kw), prefill=True)
                plain_ms = cuda_time(lambda: twin(*pos, **kw), n=5, warmup=1,
                                      prefill=True)
                bnd, by = bound_ms(case["io"](pos, kw, outs), case["ops"],
                                   case["kind"])
                line += (f" | kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, bound "
                         f"{bnd:.3f} ms ({by})")
                lib_ms = None
                if case["lib"] is not None:
                    lib_ms = cuda_time(case["lib"](pos, kw), prefill=True)
                    line += (f", cuDNN bf16 conv {lib_ms:.3f} ms: kernel / "
                             f"cuDNN {ms / lib_ms:.2f}x")
                else:
                    line += (f", bound / kernel {bnd / ms:.1%} ({by}), library "
                             "— (no single PyTorch call dequantises, adds and "
                             "requantises per group)")
                if bsz == 2 and case["timed"]:  # the main path, each shape once
                    entry["ms"] += ms
                    entry["plain_ms"] += plain_ms
                    entry["bound_ms"] += bnd
                    entry["_bytes" if by == "bytes" else "_ops"] += bnd
                    if lib_ms is None:
                        entry["library_ms"] = None
                    else:
                        entry["library_ms"] += lib_ms
                log(line)
    for name in INT8_STORE_KERNELS:
        entry = summary[name]
        entry["bound_by"] = ("bytes" if entry.pop("_bytes") >= entry.pop("_ops")
                             else "operations")
        lib = entry["library_ms"]
        log(f"[int8] sum B2 bf16 {name:20s} kernel {entry['ms']:.3f} ms"
            + (f", cuDNN {lib:.3f} ms: {entry['ms'] / lib:.2f}x" if lib
               else ", library —")
            + f"; bound / kernel {entry['bound_ms'] / entry['ms']:.1%} "
            f"({entry['bound_by']})")


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

    from ddim_audio_tpu_torch.config import load_config, production_eval_cfg
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
    ref = apply_model(params, x, t, plain_cfg(cfg))
    outs = {}
    for name, c, p, thresh, want in (
            ("float taps fp32", cfg, params, SNR_FWD_FP32_DB, PER_FORWARD_FLOAT),
            ("float taps bf16", cfg16, p16, SNR_FWD_BF16_DB, PER_FORWARD_FLOAT),
            ("production (bf16, int8 taps)", cfg_prod, p_prod,
             SNR_FWD_PROD_GN3_DB, PER_FORWARD_PROD)):
        reset_launch_counts()
        out = from_flat(apply_model_flat_io(p, xf, t, c))
        torch.cuda.synchronize()
        counts = forward_counts()
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
    ref16 = apply_model(p16, x, t, plain_cfg(cfg16))
    log(f"[forward] plain route bf16 vs fp32 plain: SNR "
        f"{snr_db(ref16, ref):.2f} dB (for comparison)")
    p0 = init_model(torch.Generator().manual_seed(0), cfg)
    ref0 = apply_model(p0, x, t, plain_cfg(cfg))
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
        "plain route bf16 (cuDNN)": lambda: apply_model(p16, x, t,
                                                         plain_cfg(cfg16)),
        "kernel route, float taps fp32": lambda: apply_model_flat_io(params, xf,
                                                                     t, cfg),
        "plain route fp32 (cuDNN)": lambda: apply_model(params, x, t,
                                                         plain_cfg(cfg)),
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
    from ddim_audio_tpu_torch.ops import batch_sums, reset_launch_counts
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
        counts = forward_counts()
        want = {k: v * forwards for k, v in PER_FORWARD_PROD.items()}
        log(f"[slice] launches of the three CLI runs ({forwards} forwards): "
            f"{counts}")
        require(counts == want, f"main-path launches {counts} != {want}")
        for name, n in want.items():
            if n:
                summary[name]["launches"] = counts[name]
        sums = batch_sums.launches
        log(f"[slice] the statistics sums' kernel (batch_sums) in those runs: "
            f"{sums} launches, {sums / forwards:g} a forward")
        require(sums > 0 and sums % forwards == 0, f"batch_sums launched "
                f"{sums} times in {forwards} forwards")

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
    from ddim_audio_tpu_torch.ops import reset_launch_counts
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
        counts = forward_counts()
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

    plain32 = ScanSampler(lambda p, xx, t: apply_model(p, xx, t,
                                                       plain_cfg(cfg)))
    plain16 = ScanSampler(lambda p, xx, t: apply_model(p, xx, t,
                                                       plain_cfg(cfg16)))
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


def _dw_cases(torch):
    """The weight-gradient kernels at every stage shape of one training
    microbatch: (name, label, kernel, plain, make(dtype) -> (x, g, kwargs),
    lib(x, g) -> the one PyTorch call, base F, channels, operations, the
    ``ddim_conv_dw`` mode, its plan's name and x's (T, F))."""
    from torch.nn.grad import conv2d_weight

    from ddim_audio_tpu_torch.ops import flat_grad as fg

    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    cases = []
    for i, (t, f, c) in enumerate(TRAIN_STAGES):
        x, g = rnd(1, t, f * c), rnd(1, t, f * c)
        cases.append(dict(
            name="conv_dw_flat", label=f"T{t} F{f} C{c}", kernel=fg.conv_dw_flat,
            plain=fg.conv_dw_flat_plain,
            make=lambda dt, x=x, g=g, c=c: (x.to(dt), g.to(dt), dict(c=c)),
            lib=lambda x, g, c=c: lambda: conv2d_weight(
                _nchw(x, c), (c, c, 3, 3), _nchw(g, c), padding=1),
            fb=f, c_in=c, c_out=c, ops=2.0 * 9 * c * c * t * f,
            mode=0, plan="conv3x3_dw", x_tf=(t, f)))
        if i + 1 == len(TRAIN_STAGES):
            break
        t2, f2, c2 = TRAIN_STAGES[i + 1]
        xd, gd = rnd(1, t, f * c), rnd(1, t2, f2 * c2)
        cases.append(dict(
            name="conv_down_dw_flat", label=f"T{t} F{f} {c}->{c2}",
            kernel=fg.conv_down_dw_flat, plain=fg.conv_down_dw_flat_plain,
            make=lambda dt, x=xd, g=gd, c=c, c2=c2: (
                x.to(dt), g.to(dt), dict(c_in=c, c_out=c2)),
            lib=lambda x, g, c=c, c2=c2: lambda: conv2d_weight(
                _nchw(x, c), (c2, c, 4, 4), _nchw(g, c2), stride=2, padding=1),
            fb=f2, c_in=c, c_out=c2, ops=2.0 * 16 * c * c2 * t2 * f2,
            mode=1, plan="conv_down_dw", x_tf=(t, f)))
        xu, gu = rnd(1, t2, f2 * c2), rnd(1, t, f * c)
        # the transposed conv is the adjoint of the strided conv c -> c2, so
        # its weight gradient is that conv's, with g as the input
        cases.append(dict(
            name="conv_up_dw_flat", label=f"T{t2} F{f2} {c2}->{c}",
            kernel=fg.conv_up_dw_flat, plain=fg.conv_up_dw_flat_plain,
            make=lambda dt, x=xu, g=gu, c=c, c2=c2: (
                x.to(dt), g.to(dt), dict(c_in=c2, c_out=c)),
            lib=lambda x, g, c=c, c2=c2: lambda: conv2d_weight(
                _nchw(g, c), (c2, c, 4, 4), _nchw(x, c2), stride=2, padding=1),
            fb=f2, c_in=c2, c_out=c, ops=2.0 * 16 * c * c2 * t2 * f2,
            mode=2, plan="conv_up_dw", x_tf=(t2, f2)))
    return cases


def phase_train_kernels():
    """The float-tap conv3x3, down and up kernels in fp32 (which training
    runs 2,730 / 140 / 140 times an optimizer step, all three in split TF32
    on the tensor cores) at the stage shapes of one training microbatch
    [1, 2, 1024, 256], every fusion on: agreement with the twin, the
    library's plan = the Python model, the split-TF32 variant, twice
    bit-equal, the SNR against the twin, then the kernel's, the twin's, the
    bound's (the larger of the bytes and three TF32 products an operation at
    495 TFLOP/s, the CUDA-core bound at 67 TFLOP/s beside it) and the one
    PyTorch call's time (``F.conv2d`` / ``F.conv_transpose2d`` in fp32, TF32
    off), kernel / library; then each kernel's sum over its shapes."""
    import torch

    sums = {}
    for case in _kernel_cases(torch, 1, stages=TRAIN_STAGES,
                              downs=TRAIN_DOWNS, head_tail=()):
        name = case["name"]
        pos, kw = case["make"](torch.float32)
        outs = case["kernel"](*pos, **kw)
        refs = case["twin"](*pos, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(outs[0], refs[0])
        require(rel <= TOL_FP32, f"{name} {case['label']} fp32 (training "
                f"shape): rel err {rel:.3e} > {TOL_FP32}")
        note = check_plan(case, 1, 0)
        again = case["kernel"](*pos, **kw)
        require(all(torch.equal(a, b) for a, b in zip(outs, again)),
                f"{name} {case['label']} fp32: two calls differ")
        note += f", twice bit-equal, SNR {snr_db(outs[0], refs[0]):.1f} dB"
        fma_bnd, _ = bound_ms(case["io"](pos, kw, outs), case["ops"], "fp32")
        ms = cuda_time(lambda: case["kernel"](*pos, **kw), prefill=True)
        plain_ms = cuda_time(lambda: case["twin"](*pos, **kw), n=5, warmup=1,
                              prefill=True)
        lib_ms = cuda_time(case["lib"](pos, kw), prefill=True)
        bnd, by = bound_ms(case["io"](pos, kw, outs), case["ops"], "tf32x3")
        log(f"[train-kernels] {name:14s} B1 {case['label']:18s} fp32 rel "
            f"{rel:.2e}{note} | kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, "
            f"bound {bnd:.3f} ms ({by}, CUDA-core bound {fma_bnd:.3f} ms), "
            f"cuDNN fp32 (TF32 off) {lib_ms:.3f} ms: kernel / cuDNN "
            f"{ms / lib_ms:.2f}x, bound / kernel {bnd / ms:.1%}")
        acc = sums.setdefault(name, [0.0] * 5)
        for i, v in enumerate((ms, bnd, fma_bnd, lib_ms, plain_ms)):
            acc[i] += v
    for name, (ms, bnd, fma_bnd, lib_ms, plain_ms) in sums.items():
        log(f"[train-kernels] sum B1 fp32 {name:14s} kernel {ms:.3f} / bound "
            f"{bnd:.3f} (CUDA cores {fma_bnd:.3f}) / cuDNN {lib_ms:.3f} / twin "
            f"{plain_ms:.3f} ms: kernel / cuDNN {ms / lib_ms:.2f}x")


def phase_train_update():
    """[train-update]: the one-pass update against its per-leaf twin at
    audio.yml's whole tree, then its time."""
    import torch

    from ddim_audio_tpu_torch.config import load_config
    from ddim_audio_tpu_torch.models.unet import ModelConfig, init_model
    from ddim_audio_tpu_torch.ops import train_update as tu
    from ddim_audio_tpu_torch.training.train_step import (init_train_state,
                                                          update_fused,
                                                          update_plain)
    from ddim_audio_tpu_torch.utils.tree import tree_leaves, tree_paths

    config = load_config("configs/audio.yml")
    params = init_model(torch.Generator().manual_seed(0),
                        ModelConfig.from_config(config))
    state, tx = init_train_state(params, config.optimization, use_ema=True)
    rate = float(config.model.ema_rate)
    leaves = tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    require(n == PARAMS_AUDIO_YML, f"{n} parameters")
    given = (state.params, state.opt_state, state.ema)
    gen = torch.Generator("cuda").manual_seed(21)

    def arrays(out):
        """{kind + leaf path: numpy} of parameters, average, moments."""
        params, opt_state, ema = out[:3]
        d = {f"params{k}": v for k, v in tree_paths(params).items()}
        d.update({f"ema{k}": v for k, v in tree_paths(ema).items()})
        for name, opt in tx.optimizers.items():
            first, second = opt.rule.moments(opt_state[name])
            d.update({f"mu{k}": v for k, v in tree_paths(first).items()})
            d.update({f"nu{k}": v for k, v in tree_paths(second).items()})
        return {k: v.cpu().numpy() for k, v in d.items()}

    def grads_of(scale, count):
        return [count * scale * torch.randn(p.shape, generator=gen,
                                            device="cuda") for p in leaves]

    before = arrays(given)
    for label, scale, count in (("clip not engaged", 1e-5, 1),
                                ("clip engaged, grad_accum 2", 1e-3, 2)):
        grads = grads_of(scale, count)
        launched = tu.train_update.launches
        fused = update_fused(tx, grads, *given, rate, count)
        launched = tu.train_update.launches - launched
        plain = update_plain(tx, grads, *given, rate, count)
        got, ref = arrays(fused), arrays(plain)
        norm = float(plain[3])
        norm_gap = abs(float(fused[3]) - norm) / norm
        un_f = float(fused[1]["default"]["update_norm"])
        un_p = float(plain[1]["default"]["update_norm"])
        un_gap = abs(un_f - un_p) / un_p
        require(launched == UPDATE_LAUNCHES,
                f"[train-update] {launched} launches")
        require(norm_gap <= TOL_UPDATE_NORMS and un_gap <= TOL_UPDATE_NORMS,
                f"[train-update] grad_norm {norm_gap:.2e}, update_norm "
                f"{un_gap:.2e} apart")
        if count == 1:
            require(norm < 1.0, f"[train-update] norm {norm} engages the clip")
            differ = [k for k in ref if not np.array_equal(got[k], ref[k])]
            require(not differ, f"[train-update] {len(differ)} leaves differ, "
                    f"first {differ[:3]}")
            detail = f"all {len(ref)} leaves bit-equal"
        else:
            require(norm >= 1.0, f"[train-update] norm {norm} under the clip")
            parts = []
            for kind in ("params", "ema", "mu", "nu"):
                worst, key, nl, ulp_n, bad_n, entries = _move_gaps(
                    got, ref, before, kind)
                require(bad_n == 0, f"[train-update] {kind}: {bad_n} entries "
                        f"beyond {TOL_GRAD_LEAF} of the move plus a unit")
                parts.append(f"{kind} {nl} leaves, worst {worst:.2e} at {key}"
                             f", {ulp_n} of {entries} needed the unit")
            detail = "; ".join(parts)
        log(f"[train-update] {label} (grad_norm {norm:.4f}): {launched} "
            f"launches; grad_norm {norm_gap:.1e} and update_norm {un_gap:.1e} "
            f"apart; {detail}")

    grads = grads_of(1e-5, 1)
    for _ in range(2):
        update_fused(tx, grads, *given, rate, 1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    calls = 10
    torch.cuda.synchronize()
    torch.cuda._sleep(PREFILL_UPDATE_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        update_fused(tx, grads, *given, rate, 1)
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    end.record()
    require(not end.query(), "[train-update] the card ran dry while the host "
            "queued the timed calls: raise PREFILL_UPDATE_CYCLES")
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / calls
    plain_ms = cuda_time(lambda: update_plain(tx, grads, *given, rate, 1),
                         n=3, warmup=1)
    bound = 10 * 4 * n / PEAK_BYTES * 1e3
    log(f"[train-update] {n} parameters in {len(leaves)} leaves: kernel "
        f"{ms:.3f} ms / bound {bound:.3f} ms (bytes: 10 fp32 values a "
        f"parameter; {bound / ms:.0%} of it), host {host_ms:.2f} ms a call; "
        f"per-leaf route {plain_ms:.1f} ms a call (the host's pace)")


def _int8_store_config(path):
    """audio.yml as shipped plus ``sampling.act_store: int8`` and
    ``sampling.strided_int8: true``, written to path."""
    import yaml

    with open("configs/audio.yml") as f:
        raw = yaml.safe_load(f)
    raw["sampling"].update(act_store="int8", strided_int8=True)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def phase_int8_store(summary, cfg, params):
    """The int8-storage configuration (audio.yml + act_store: int8 +
    strided_int8: true, bf16, tap_int8 as shipped): the full-width forward
    against the fp32 plain route on both weight sets, with its launch counts,
    every wrapper call shadowed by its kernel, its time beside the
    production route's; then the command line's 10-step last-only run at
    B = 2 on a checkpoint of the weights, held against the same run through
    the twins."""
    import logging
    from types import SimpleNamespace

    import torch

    from ddim_audio_tpu_torch import cli
    from ddim_audio_tpu_torch.config import load_config, production_eval_cfg
    from ddim_audio_tpu_torch.diffusion.schedules import \
        make_timestep_subsequence
    from ddim_audio_tpu_torch.models.unet import (
        act_store_int8_stage, apply_model, apply_model_flat_io,
        flat_io_adapters, init_model, prepare_params, strided_int8_transition)
    from ddim_audio_tpu_torch.ops import reset_launch_counts
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
    from ddim_audio_tpu_torch.tools import forward_input
    from ddim_audio_tpu_torch.weights import save_eval_checkpoint

    with tempfile.TemporaryDirectory() as exp:
        path = _int8_store_config(os.path.join(exp, "audio_int8.yml"))
        config = load_config(path)
        cfg_i8 = production_eval_cfg(config, cfg)
        cfg_prod = production_eval_cfg(load_config("configs/audio.yml"), cfg)
        require(cfg_i8.dtype == torch.bfloat16 and cfg_i8.tap_int8
                and cfg_i8.act_store == "int8" and cfg_i8.strided_int8,
                f"int8-storage config is {cfg_i8}")
        stages = [c for c in cfg.ch if act_store_int8_stage(cfg_i8, c)]
        trans = [f"down {a}->{b}" for a, b in zip(cfg.ch, cfg.ch[1:])
                 if strided_int8_transition(cfg_i8, a, b)] + [
            f"up {b}->{a}" for a, b in zip(cfg.ch, cfg.ch[1:])
            if strided_int8_transition(cfg_i8, b, a, up=True)]
        log(f"[int8] audio.yml + sampling.act_store int8 + strided_int8 true "
            f"(bf16, tap_int8 true): int8 storage at C {stages}, int8 strided "
            f"taps at {trans}")
        require(stages == [32, 64, 96, 128] and trans == [
            "down 32->64", "up 64->32", "up 256->192"],
            "the int8 stages / transitions differ from the JAX dispatch")

        x, t = forward_input(cfg)
        to_flat, from_flat = flat_io_adapters(cfg)
        xf = to_flat(x).contiguous()
        p_i8 = prepare_params(params, cfg_i8)
        p_prod = prepare_params(params, cfg_prod)
        ref = apply_model(params, x, t, plain_cfg(cfg))
        torch.cuda.synchronize()
        reset_launch_counts()
        out = from_flat(apply_model_flat_io(p_i8, xf, t, cfg_i8))
        torch.cuda.synchronize()
        counts = forward_counts()
        require(bool(torch.isfinite(out).all()), "int8-storage forward not "
                "finite")
        snr = snr_db(out, ref)
        log(f"[int8] kernel route, int8 storage, vs fp32 plain: SNR {snr:.2f} "
            f"dB (>= {SNR_FWD_I8_GN3_DB}) | launches {counts}")
        require(counts == PER_FORWARD_I8, f"launches per forward {counts} != "
                f"{PER_FORWARD_I8}")
        require(snr >= SNR_FWD_I8_GN3_DB, f"int8-storage forward SNR "
                f"{snr:.2f} < {SNR_FWD_I8_GN3_DB} dB")
        shadow = Shadow()
        with reference_route(shadow=shadow):
            twin = from_flat(apply_model_flat_io(p_i8, xf, t, cfg_i8))
        shadow.check("[int8] forward, B1,", PER_FORWARD_I8)
        snr_t = snr_db(out, twin)
        log(f"[int8] kernel route vs the same forward through the plain twins: "
            f"SNR {snr_t:.2f} dB (>= {SNR_FWD_I8_TWIN_DB}); twins vs fp32 plain "
            f"{snr_db(twin, ref):.2f} dB")
        require(snr_t >= SNR_FWD_I8_TWIN_DB, f"int8-storage forward vs its "
                f"twin route: SNR {snr_t:.2f} < {SNR_FWD_I8_TWIN_DB} dB")
        del twin
        p0 = init_model(torch.Generator().manual_seed(0), cfg)
        ref0 = apply_model(p0, x, t, plain_cfg(cfg))
        out0 = from_flat(apply_model_flat_io(prepare_params(p0, cfg_i8), xf, t,
                                             cfg_i8))
        snr0 = snr_db(out0, ref0)
        log(f"[int8] kernel route, int8 storage, init weights (GN3 = 0), vs "
            f"fp32 plain: SNR {snr0:.2f} dB (>= {SNR_FWD_I8_INIT_DB}; the JAX "
            "package's own guard of this route is 38 dB)")
        require(snr0 >= SNR_FWD_I8_INIT_DB, f"int8-storage forward on init "
                f"weights: SNR {snr0:.2f} < {SNR_FWD_I8_INIT_DB} dB")
        del p0, ref0, out0
        times = {
            "kernel route, int8 storage": lambda: apply_model_flat_io(
                p_i8, xf, t, cfg_i8),
            "kernel route, production": lambda: apply_model_flat_io(
                p_prod, xf, t, cfg_prod),
        }
        for rnd in (1, 2):
            for label, fn in times.items():
                log(f"[int8] round {rnd}, {label}: "
                    f"{cuda_time(fn, n=5, warmup=1):.2f} ms / forward")
        del p_i8, p_prod

        # the command line on a checkpoint of these weights
        save_eval_checkpoint(os.path.join(exp, "logs", "smoke"), params)
        steps, clips, seed = 10, 2, 1234
        exported = []
        export = Diffusion.export

        def checked_export(self, arr, names):
            require(arr.shape == (clips, 2, 8192, 256),
                    f"exported array of shape {arr.shape}")
            require(bool(np.isfinite(arr).all()),
                    f"non-finite output in {list(names)}")
            exported.append(list(names))
            return export(self, arr, names)

        torch.cuda.synchronize()
        reset_launch_counts()
        Diffusion.export = checked_export
        t0 = time.perf_counter()
        try:
            code = cli.main(["--config", path, "--doc", "smoke", "--exp", exp,
                             "--ni", "--sample", "--verbose", "warning",
                             "--timesteps", str(steps), "-i", "cli"])
        finally:
            Diffusion.export = export
            logging.getLogger().handlers.clear()
        wall = time.perf_counter() - t0
        require(code == 0, f"int8-storage CLI run exited {code}")
        require(len(exported) == 1, f"CLI run exported {len(exported)} arrays")
        forwards = len(make_timestep_subsequence(1000, steps, "uniform"))
        counts = forward_counts()
        want = {k: v * forwards for k, v in PER_FORWARD_I8.items()}
        log(f"[int8] CLI DDIM last-only, --timesteps {steps}, {clips} clips "
            f"[2, 2, 8192, 256]: exit 0, 4 files, every exported array "
            f"finite, host wall {wall:.2f} s | launches ({forwards} forwards) "
            f"{counts}")
        require(counts == want, f"int8-storage CLI launches {counts} != {want}")
        for name in INT8_STORE_KERNELS:  # the main path's count stands
            summary[name].setdefault("launches", counts[name])
        _count_files(os.path.join(exp, "image_samples", "cli"),
                     [f"{j}_final{ext}" for j in range(clips)
                      for ext in (".png", ".wav")])
        outs = {}
        for route in ("kernels", "twins"):
            args = SimpleNamespace(
                seed=seed, timesteps=steps, skip_type="uniform", eta=0.0,
                sample_type="generalized",
                image_folder=os.path.join(exp, "image_samples", route))
            with reference_route(force=route == "twins"):
                outs[route] = Diffusion(args, config).sample_last_only(params)
        for j in range(clips):
            wav = [_read_wav(os.path.join(exp, "image_samples", d,
                                          f"{j}_final.wav"))
                   for d in ("cli", "kernels")]
            same = bool(np.array_equal(wav[0], wav[1]))
            snr = snr_db(torch.from_numpy(outs["kernels"][j]),
                         torch.from_numpy(outs["twins"][j]))
            log(f"[int8] clip {j}: the runner's WAV equals the command line's: "
                f"{same}; kernels vs twins, {steps}-step sample: SNR {snr:.2f} "
                f"dB (>= {SNR_I8_CLI_TWIN_DB})")
            require(same and float(np.abs(wav[0]).max()) > 0,
                    f"clip {j}: silent or not the command line's")
            require(snr >= SNR_I8_CLI_TWIN_DB, f"clip {j}: kernels vs twins "
                    f"SNR {snr:.2f} < {SNR_I8_CLI_TWIN_DB} dB")


def check_dw_plan(case, bsz, bf16):
    """A weight-gradient kernel's call: the library's plan equals the Python
    model, fp32 takes the split-TF32 variant and the library sizes the
    partials from the plan. Returns (the plan, the note for the line)."""
    from ddim_audio_tpu_torch.ops import _cuda, tile_plan

    lib = _cuda.kernels()
    t, f = case["x_tf"]
    shape = (t, f, case["c_in"], case["c_out"])
    kind = case["plan"]
    model = getattr(tile_plan, f"{kind}_plan")(*shape, bool(bf16), bsz)
    got = tile_plan.library_plan(getattr(lib, f"ddim_{kind}_plan"), *shape,
                                 bf16, bsz)
    tag = f"{case['name']} B{bsz} {case['label']} bf16={bf16}"
    require(got == model, f"{tag}: library plan {got} != Python model {model}")
    require(lib.ddim_conv_dw_splits(case["mode"], bsz, *shape, bf16) ==
            got.split, f"{tag}: partials differ from the plan's split")
    if not bf16:
        require(got.variant == tile_plan.VARIANT_TF32,
                f"{tag}: variant {got.variant}, want split TF32")
    return got, (f", plan {VARIANT_NAMES[got.variant]} tile {got.tile_t}x"
                 f"{got.tile_f} blocks {got.groups}x{got.split}")


def phase_dw_kernels(summary):
    import torch

    from ddim_audio_tpu_torch.ops import tile_plan

    for case in _dw_cases(torch):
        name, label = case["name"], "B1 " + case["label"]
        entry = summary.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": 0.0, "_bytes": 0.0, "_ops": 0.0,
            "_fma_bound": 0.0})
        for dtype, dt in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            x, g, kw = case["make"](dtype)
            out = case["kernel"](x, g, **kw)
            again = case["kernel"](x, g, **kw)
            ref = case["plain"](x, g, **kw)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            require(out.dtype == torch.float32, f"{name}: dW is {out.dtype}")
            require(bool(torch.equal(out, again)),
                    f"{name} {label} {dt}: two runs differ")
            require(rel <= TOL_DW, f"{name} {label} {dt}: rel err {rel:.3e} > "
                    f"{TOL_DW}")
            plan, note = check_dw_plan(case, 1, int(dtype == torch.bfloat16))
            ms = cuda_time(lambda: case["kernel"](x, g, **kw), prefill=True)
            plain_ms = cuda_time(lambda: case["plain"](x, g, **kw), n=5,
                                 warmup=1, prefill=True)
            lib_ms = cuda_time(case["lib"](x, g), prefill=True)
            # the unit the plan's variant uses: bf16 or split-TF32 tensor
            # cores, or CUDA cores (their bound beside the split-TF32 one)
            tf32x3 = plan.variant == tile_plan.VARIANT_TF32
            kind = ("tf32x3" if tf32x3 else "bf16"
                    if plan.variant == tile_plan.VARIANT_MMA else "fp32")
            bnd, by = bound_ms([x, g, out], case["ops"], kind)
            if tf32x3:
                fma_bnd, _ = bound_ms([x, g, out], case["ops"], "fp32")
                note += f" | CUDA-core bound {fma_bnd:.3f} ms"
                entry["_fma_bound"] += fma_bnd
            tf32 = "" if dtype == torch.bfloat16 else ", TF32 off"
            log(f"[kernels] {name:17s} {label:23s} {dt} max_abs {err:.3e} rel "
                f"{rel:.3e} (<= {TOL_DW}), twice bit-equal{note} | kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd:.3f} ms "
                f"({by}{', split TF32' if tf32x3 else ''}), conv2d_weight "
                f"({dt}{tf32}) {lib_ms:.3f} ms: kernel / library "
                f"{ms / lib_ms:.2f}x")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if dtype == torch.float32:  # the main path trains in fp32
                entry["ms"] += ms
                entry["plain_ms"] += plain_ms
                entry["bound_ms"] += bnd
                entry["library_ms"] += lib_ms
                entry["_bytes" if by == "bytes" else "_ops"] += bnd
    for name in DW_KERNELS:
        entry = summary[name]
        entry["bound_by"] = ("bytes" if entry.pop("_bytes") >= entry.pop("_ops")
                             else "operations")
        log(f"[kernels] sum B1 fp32 {name:17s} kernel {entry['ms']:.3f} / "
            f"bound {entry['bound_ms']:.3f} (split TF32; CUDA cores "
            f"{entry.pop('_fma_bound'):.3f}) / conv2d_weight "
            f"{entry['library_ms']:.3f} / plain {entry['plain_ms']:.3f} ms: "
            f"kernel / library {entry['ms'] / entry['library_ms']:.2f}x")


def phase_grad(cfg, params):
    """One training microbatch of the full model: kernel route, twin route
    with the shadow, plain autograd route."""
    import dataclasses

    import torch

    from ddim_audio_tpu_torch.diffusion.schedules import make_schedule
    from ddim_audio_tpu_torch.models.unet import apply_model
    from ddim_audio_tpu_torch.ops import launch_counts, reset_launch_counts
    from ddim_audio_tpu_torch.training.losses import noise_estimation_loss
    from ddim_audio_tpu_torch.utils.tree import tree_leaves, tree_paths

    gen = torch.Generator().manual_seed(11)
    x0 = (0.5 * torch.randn((1, cfg.channels, 1024, cfg.f_size),
                            generator=gen)).cuda()
    e = torch.randn(x0.shape, generator=gen).cuda()
    t = torch.tensor([500], device="cuda")
    alphas = torch.as_tensor(
        make_schedule("linear", 1e-4, 0.02, 1000).alphas_cumprod,
        dtype=torch.float32, device="cuda")
    leaves = tree_leaves(params)
    names = list(tree_paths(params))
    log(f"[grad] audio.yml, {PARAMS_AUDIO_YML} params in {len(leaves)} leaves, "
        "one microbatch x0 [1, 2, 1024, 256], t [500], fp32, remat, non-zero "
        "GN3 weights, no dropout")

    def grads_of(c):
        def apply_fn(p, x, tt):
            return apply_model(p, x, tt, c, train=True)

        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = noise_estimation_loss(apply_fn, params, x0, t, e, alphas)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), grads

    torch.cuda.synchronize()
    reset_launch_counts()
    loss_k, g_k = grads_of(cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[grad] kernel route: loss {loss_k.item():.4f} | launches per "
        f"microbatch {counts}")
    require(counts == PER_MICROBATCH, f"launches per microbatch {counts} != "
            f"{PER_MICROBATCH}")
    _, g_again = grads_of(cfg)
    require(all(torch.equal(a, b) for a, b in zip(g_k, g_again)),
            "two kernel-route backward passes differ")
    log("[grad] kernel route: a second forward + backward gives the same bits "
        "for every leaf")

    shadow = Shadow()
    with reference_route(shadow=shadow):
        loss_t, g_t = grads_of(cfg)
    shadow.check("[grad] B1 fp32,",
                 PER_MICROBATCH,
                 floor_db=SHADOW_GRAD_FP32_DB)

    old, torch.backends.cudnn.deterministic = \
        torch.backends.cudnn.deterministic, True
    try:
        loss_p, g_p = grads_of(dataclasses.replace(cfg, conv_impl="xla"))
    finally:
        torch.backends.cudnn.deterministic = old
    gmax = max(g.abs().max().item() for g in g_p)
    for label, g_x, loss_x in (("kernel route", g_k, loss_k),
                               ("twin route", g_t, loss_t)):
        worst, worst_name, num, den = 0.0, "", 0.0, 0.0
        for name, a, b in zip(names, g_x, g_p):
            require(bool(torch.isfinite(a).all()), f"{label}: grad of {name} "
                    "not finite")
            scale = max(b.abs().max().item(), 1e-3 * gmax)
            rel = (a - b).abs().max().item() / scale
            if rel > worst:
                worst, worst_name = rel, name
            num += ((a.double() - b.double()) ** 2).sum().item()
            den += (b.double() ** 2).sum().item()
        snr = 10 * math.log10(den / max(num, 1e-300))
        log(f"[grad] {label} vs plain autograd (cuDNN fp32, TF32 off, "
            f"deterministic): loss {loss_x.item():.4f} vs {loss_p.item():.4f}; "
            f"{len(names)} leaves, worst leaf rel {worst:.3e} (<= "
            f"{TOL_GRAD_LEAF}) at {worst_name}; all gradients SNR {snr:.1f} dB")
        require(abs(loss_x.item() - loss_p.item())
                <= 1e-4 * abs(loss_p.item()), f"{label}: loss differs")
        require(worst <= TOL_GRAD_LEAF, f"{label}: gradient of {worst_name} "
                f"off by {worst:.3e} of its scale")
    del g_t, g_p, g_again
    for rnd in (1, 2):
        ms_k = cuda_time(lambda: grads_of(cfg), n=3, warmup=1)
        ms_p = cuda_time(lambda: grads_of(
            dataclasses.replace(cfg, conv_impl="xla")), n=3, warmup=1)
        log(f"[grad] round {rnd}, forward + backward of one microbatch: kernel "
            f"route {ms_k:.1f} ms, plain autograd route {ms_p:.1f} ms")


def _train_config(path, data, *, n_iters, dtype=None):
    """audio.yml as shipped but for the run's data folder and length."""
    import yaml

    with open("configs/audio.yml") as f:
        raw = yaml.safe_load(f)
    raw["data"]["path"] = data
    raw["training"].update(n_iters=n_iters, snapshot_freq=1000,
                           validation_freq=2)
    if dtype:
        raw["model"]["dtype"] = dtype
    require(raw["training"]["batch_size"] == 14
            and raw["training"]["grad_accum"] == 14
            and raw["model"]["dtype"] == (dtype or "float32"),
            "audio.yml is not batch 14, grad_accum 14, fp32")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _logged(log_path):
    """(train losses by step, validation losses by step) from stdout.txt."""
    import re

    losses, vals = {}, {}
    with open(os.path.join(log_path, "stdout.txt")) as f:
        for line in f:
            m = re.search(r"step: (\d+), loss: ([-\w.]+)", line)
            if m:
                losses[int(m.group(1))] = float(m.group(2))
            m = re.search(r"step: (\d+), val-loss: ([-\w.]+)", line)
            if m:
                vals[int(m.group(1))] = float(m.group(2))
    return losses, vals


def phase_train(summary):
    """This slice's main path: the command line → Diffusion.train → the
    train step at audio.yml's full width and depth."""
    import logging

    import torch

    from ddim_audio_tpu_torch import cli
    from ddim_audio_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                          train_update)

    def run(exp, config, doc, *flags):
        t0 = time.perf_counter()
        try:
            code = cli.main(["--config", config, "--doc", doc, "--exp", exp,
                             "--ni", "--verbose", "info", *flags])
        finally:
            logging.getLogger().handlers.clear()
        torch.cuda.synchronize()
        require(code == 0, f"CLI {doc} {' '.join(flags)} exited {code}")
        return time.perf_counter() - t0

    def arrays(path):
        with np.load(path) as data:
            return {k: data[k] for k in data.files if k != "__meta__"}

    with tempfile.TemporaryDirectory() as tmp:
        data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
        os.makedirs(data)
        rng = np.random.default_rng(5)
        window = 1024 * 255  # t_size · hop samples per item
        for i in range(16):  # the 90/10 split leaves 14 to train, 2 held out
            wave = 0.1 * rng.standard_normal(window).astype(np.float32)
            np.save(os.path.join(data, f"clip{i:02d}.npy"), wave)
        cfg3 = _train_config(os.path.join(tmp, "three.yml"), data, n_iters=3)
        cfg5 = _train_config(os.path.join(tmp, "five.yml"), data, n_iters=5)
        log("[train] audio.yml (batch 14, grad_accum 14, fp32, remat) with "
            "data.path -> 16 seed-made .npy waveforms of 261,120 samples, "
            "snapshot_freq 1000, validation_freq 2")

        torch.cuda.synchronize()
        reset_launch_counts()
        wall = run(exp, cfg3, "a")
        counts = launch_counts()
        updates = train_update.train_update.launches
        steps = 3
        # 14 microbatches a step, and the validation forward at step 2 (the
        # eval route in fp32: float taps, head and tail kernels)
        want = {k: v * 14 * steps for k, v in PER_MICROBATCH.items()}
        for k, v in PER_FORWARD_FLOAT.items():
            want[k] += v
        log(f"[train] CLI train, 3 steps + validation: exit 0, host wall "
            f"{wall:.1f} s (dataset, init, 2 checkpoints of the whole "
            f"TrainState included) | launches {counts}; one-pass update "
            f"{updates} ({UPDATE_LAUNCHES} a step)")
        require(counts == want, f"training launches {counts} != {want}")
        require(updates == UPDATE_LAUNCHES * steps, f"training's one-pass "
                f"update launched {updates} != {UPDATE_LAUNCHES * steps}")
        for name, n in counts.items():
            summary[name]["launches_train_path"] = n
        for name in DW_KERNELS:
            require(counts[name] > 0, f"{name} never launched in training")
            summary[name]["launches"] = counts[name]
        log_a = os.path.join(exp, "logs", "a")
        for name in ("ckpt.npz", "ckpt_1.npz", "ckpt_3.npz", "config.yml"):
            require(os.path.exists(os.path.join(log_a, name)),
                    f"{name} missing after training")
        losses, vals = _logged(log_a)
        require(sorted(losses) == [1, 2, 3] and sorted(vals) == [2],
                f"logged steps {sorted(losses)}, validation {sorted(vals)}")
        require(all(math.isfinite(v) for v in [*losses.values(),
                                               *vals.values()]),
                f"non-finite loss logged: {losses} {vals}")
        log(f"[train] logged losses {losses}, validation {vals}: all finite")
        os.remove(os.path.join(log_a, "ckpt_1.npz"))
        os.remove(os.path.join(log_a, "ckpt_3.npz"))

        wall = run(exp, cfg5, "a", "--resume_training")
        losses_a, _ = _logged(log_a)
        require(sorted(losses_a) == [1, 2, 3, 4, 5], f"resumed run logged steps "
                f"{sorted(losses_a)}")
        log(f"[train] CLI --resume_training to step 5: exit 0, host wall "
            f"{wall:.1f} s, losses {losses_a}")
        os.remove(os.path.join(log_a, "ckpt_5.npz"))
        wall = run(exp, cfg5, "b")
        log_b = os.path.join(exp, "logs", "b")
        losses_b, _ = _logged(log_b)
        resumed, whole = (arrays(os.path.join(d, "ckpt.npz"))
                          for d in (log_a, log_b))
        require(resumed.keys() == whole.keys(), "checkpoint keys differ")
        differ = [k for k in whole if not np.array_equal(resumed[k], whole[k])]
        kinds = {k.split("[")[0].split(".")[1] for k in whole}
        log(f"[train] unbroken 5-step run: host wall {wall:.1f} s, losses "
            f"{losses_b}; its checkpoint vs the resumed run's: {len(whole)} "
            f"arrays ({', '.join(sorted(kinds))}), {len(differ)} differ")
        require(not differ, f"resume is not bit-identical: {differ[:5]}")
        require(losses_a == losses_b, "resumed and unbroken losses differ")
        require(int(whole[".step"]) == 5, f"step {whole['.step']}")
        del resumed, whole
        for name in os.listdir(log_b):
            if name.endswith(".npz"):
                os.remove(os.path.join(log_b, name))

        wall = run(exp, cfg5, "a", "--test")
        log(f"[train] CLI --test on that checkpoint: exit 0, host wall "
            f"{wall:.1f} s")
        wall = run(exp, cfg5, "a", "--sample", "--timesteps", "3", "-i", "own")
        folder = os.path.join(exp, "image_samples", "own")
        _count_files(folder, [f"{j}_final{ext}" for j in range(2)
                              for ext in (".png", ".wav")])
        for j in range(2):
            wav = _read_wav(os.path.join(folder, f"{j}_final.wav"))
            require(bool(np.isfinite(wav).all()) and np.abs(wav).max() > 0,
                    f"clip {j} of the trained checkpoint is silent or not "
                    "finite")
        log(f"[train] CLI --sample (last-only, 3 steps, 2 clips "
            f"[2, 2, 8192, 256]) from the checkpoint the port trained: 4 "
            f"files, finite, host wall {wall:.1f} s")

        cfg16 = _train_config(os.path.join(tmp, "bf16.yml"), data, n_iters=2,
                              dtype="bfloat16")
        wall = run(exp, cfg16, "h")
        losses_h, _ = _logged(os.path.join(exp, "logs", "h"))
        rels = {s: abs(losses_h[s] - losses_b[s]) / abs(losses_b[s])
                for s in (1, 2)}
        log(f"[train] model.dtype bfloat16, 2 steps: host wall {wall:.1f} s, "
            f"losses {losses_h} vs fp32 {[losses_b[s] for s in (1, 2)]}: rel "
            f"{rels} (<= {TOL_BF16_LOSS})")
        require(max(rels.values()) <= TOL_BF16_LOSS,
                f"bf16 loss off by {rels}")

    _time_train_step()


def _time_train_step():
    """ms per optimizer step (14 microbatches, clip, optimizers, EMA) by CUDA
    events, fp32 and bf16 compute, on seed-made data."""
    import dataclasses

    import torch

    from ddim_audio_tpu_torch.config import load_config
    from ddim_audio_tpu_torch.diffusion.schedules import make_schedule
    from ddim_audio_tpu_torch.models.unet import ModelConfig, init_model
    from ddim_audio_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                          train_update)
    from ddim_audio_tpu_torch.training.train_step import (init_train_state,
                                                          make_train_step)

    config = load_config("configs/audio.yml")
    cfg = ModelConfig.from_config(config)
    alphas = make_schedule("linear", 1e-4, 0.02, 1000).alphas_cumprod
    gen = torch.Generator("cuda").manual_seed(3)
    x0 = 0.5 * torch.randn((14, 2, 1024, 256), generator=gen, device="cuda")
    for label, c in (("fp32", cfg), ("bf16 compute", dataclasses.replace(
            cfg, dtype=torch.bfloat16))):
        params = init_model(torch.Generator().manual_seed(0), cfg)
        state, tx = init_train_state(params, config.optimization, use_ema=True)
        step = make_train_step(c, config, alphas, tx)
        state, _ = step(state, x0, gen)  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats()
        start.record()
        for _ in range(2):
            state, metrics = step(state, x0, gen)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 2
        updates = train_update.train_update.launches
        require(all(bool(torch.isfinite(v)) for v in metrics.values()),
                f"metrics not finite: {metrics}")
        log(f"[train] train_step, {label}, batch 14 x [2, 1024, 256], "
            f"grad_accum 14, remat: {ms:.1f} ms per optimizer step, "
            f"{ms / 14:.1f} ms per microbatch (CUDA events, mean of 2 steps); "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB; launches of the 2 steps {launch_counts()}, one-pass "
            f"update {updates}")
        # fp32 parameters in both: bf16 compute keeps fp32 leaves
        require(updates == 2 * UPDATE_LAUNCHES, f"train_step {label}: the "
                f"one-pass update launched {updates} in 2 steps")
        del state, params


def _parallel_cli_refusal():
    """The command line with ``parallel: {dp: 2}`` in one plain process (no
    launcher: one rank) exits 1 with the mesh's error."""
    import logging

    import yaml

    from ddim_audio_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        with open("configs/audio.yml") as f:
            raw = yaml.safe_load(f)
        raw["parallel"] = {"dp": 2, "sp": 1}
        path = os.path.join(tmp, "audio_dp2.yml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        seen = []

        class Keep(logging.Handler):
            def emit(self, record):
                seen.append(record.getMessage())

        keep = Keep(level=logging.ERROR)
        logging.getLogger().addHandler(keep)
        try:
            code = cli.main(["--config", path, "--doc", "none", "--exp", tmp,
                             "--ni", "--sample", "--verbose", "error",
                             "--timesteps", "2", "-i", "x"])
        finally:
            logging.getLogger().handlers.clear()
    want = "mesh dp×sp = 2×1 needs 2 devices, have 1"
    text = "\n".join(seen)
    log(f"[parallel] CLI, parallel dp 2 in one plain process: exit {code}, "
        f"'{want}' in the log: {want in text}")
    require(code == 1 and want in text, f"CLI refusal: exit {code}, log "
            f"{text[-500:]}")


def _timed(fn, n=3, clock=None):
    """Host ms per call of fn over n calls after one, the card synchronised
    (the sp forwards wait on gloo between kernels: host pace). A
    ``_CollectiveClock`` given as ``clock`` starts from 0 after the first
    call, so it covers the same n calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    if clock is not None:
        clock.calls, clock.seconds = 0, 0.0
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


class _CollectiveClock:
    """Counts the collectives the sp code issues and the host time spent
    in them: gloo's copies through host memory and the wait for the other
    rank, whose kernels share the card, together."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.calls, self.seconds = dist, 0, 0.0
        self.orig = {n: getattr(dist, n) for n in ("all_gather", "all_reduce")}

    def __enter__(self):
        def wrap(fn):
            def timed(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.calls += 1
                    self.seconds += time.perf_counter() - t0
            return timed

        for name, fn in self.orig.items():
            setattr(self.dist, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dist, name, fn)


class _BatchProbe:
    """Holds every call of a batch-B forward against the same call at B = 1
    on each clip's slice of its operands. Within the block every kernel
    wrapper (where the package's modules hold it), ``torch.matmul`` (the FNet
    GEMMs), ``F.conv2d`` / ``F.conv_transpose2d`` (the plain convs) and
    ``flat_resblock.channel_sums`` (torch's reductions of the glue) are
    replaced by a proxy that runs the call, then the call once a clip, and
    records per name: calls, calls whose per-clip outputs (statistics
    included) are not bit-equal to their slice of the batch call's, and the
    worst SNR of those. A nested wrapper call (``conv3x3_flat`` handing over
    to ``conv3x3_flat_int8``) counts once, under the outer name. The per-clip
    launches count as launches: read no launch counts inside."""

    def __init__(self, batch: int):
        self.batch, self.depth, self.rows = batch, 0, {}
        self.patched = []

    def _slice(self, v, j):
        """v with every tensor of two or more dimensions whose leading
        dimension is the batch cut to clip j (a kernel's weight leads with a
        tap row, a GEMM's with its >= 128 input features; the plain convs,
        whose weight may lead with C_out = 2, slice their input alone)."""
        import torch

        if isinstance(v, torch.Tensor):
            if v.ndim >= 2 and v.shape[0] == self.batch:
                return v[j:j + 1]
            return v
        if isinstance(v, (tuple, list)):
            return type(v)(self._slice(u, j) for u in v)
        if isinstance(v, dict):
            return {k: self._slice(u, j) for k, u in v.items()}
        return v

    def _outs(self, v):
        import torch

        if isinstance(v, torch.Tensor):
            return [v]
        return [u for u in v if isinstance(u, torch.Tensor)]

    def _proxy(self, name, fn, first_only=False):
        def cut(args, kw, j):
            if first_only:
                return (self._slice(args[0], j),) + tuple(args[1:]), kw
            return self._slice(args, j), self._slice(kw, j)

        def run(*args, **kw):
            if self.depth:
                return fn(*args, **kw)
            self.depth += 1
            try:
                both = fn(*args, **kw)
                outs = self._outs(both)
                if not outs or outs[0].shape[0] != self.batch:
                    return both
                row = self.rows.setdefault(name, [0, 0, math.inf])
                row[0] += 1
                equal, worst = True, math.inf
                for j in range(self.batch):
                    a_j, kw_j = cut(args, kw, j)
                    alone = self._outs(fn(*a_j, **kw_j))
                    for a, o in zip(alone, outs):
                        ref = o[j:j + 1]
                        if not torch_equal(a, ref):
                            equal = False
                            worst = min(worst, snr_db(a, ref))
                if not equal:
                    row[1] += 1
                    row[2] = min(row[2], worst)
                return both
            finally:
                self.depth -= 1
        run.launches = 0  # a wrapper counts its launches on its own name
        return run

    def _patch(self, owner, attr, name, **kw):
        orig = getattr(owner, attr)
        self.patched.append((owner, attr, orig))
        setattr(owner, attr, self._proxy(name, orig, **kw))

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        from ddim_audio_tpu_torch.ops import KERNEL_WRAPPERS
        from ddim_audio_tpu_torch.ops import flat_resblock

        targets = {id(fn): name for name, fn in KERNEL_WRAPPERS.items()}
        targets[id(flat_resblock.channel_sums)] = "channel_sums"
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or not mod_name.startswith("ddim_audio_tpu_torch"):
                continue
            for attr, val in list(vars(mod).items()):
                if id(val) in targets and callable(val):
                    self._patch(mod, attr, targets[id(val)])
        self._patch(torch, "matmul", "torch.matmul (cuBLAS)")
        self._patch(F, "conv2d", "F.conv2d (cuDNN)", first_only=True)
        self._patch(F, "conv_transpose2d", "F.conv_transpose2d (cuDNN)",
                    first_only=True)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self.patched):
            setattr(owner, attr, orig)
        self.patched.clear()


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a, b))


def phase_batch(config, cfg, params):
    """[batch]: whether a clip's result depends on the size of its batch.
    One forward at B = 2 (the seed-made clip and a second one) per route,
    every call held against itself at B = 1 on each clip's slice of the
    same operands (``_BatchProbe``), one line per name: the port's kernels
    and its glue's channel sums must give the same bits (BATCH_INVARIANT);
    cuBLAS (the FNet and timestep-MLP GEMMs) and cuDNN (the plain route's
    transposed convs) are the library's and only printed. Then each clip's
    whole forward at B = 1 against its slice of the B = 2 forward, and
    torch's one-reduction sum against the statistics sums' kernel the
    wrappers and the glue use (``ops.sums``) at the main path's
    shapes: bit-equality, error and time."""
    import dataclasses

    import torch

    from ddim_audio_tpu_torch.config import load_config, production_eval_cfg
    from ddim_audio_tpu_torch.models.unet import (apply_model,
                                                  apply_model_flat_io,
                                                  flat_io_adapters,
                                                  prepare_params)
    from ddim_audio_tpu_torch.ops.sums import batch_sums
    from ddim_audio_tpu_torch.ops.tile_plan import conv3x3_plan
    from ddim_audio_tpu_torch.tools import forward_input

    x, t = forward_input(cfg)
    gen2 = torch.Generator().manual_seed(2)
    x2 = torch.cat([x, torch.randn(x.shape, generator=gen2).cuda()])
    t2 = torch.tensor([500, 200], device=x.device)
    to_flat, from_flat = flat_io_adapters(cfg)
    xf2 = to_flat(x2).contiguous()

    def report(name, probe):
        for kname, (calls, unequal, worst) in sorted(probe.rows.items()):
            own = kname in BATCH_INVARIANT
            log(f"[batch] {name}: {kname}: {calls} calls, {unequal} not "
                f"bit-equal at B = 1 vs B = 2's slice"
                + (f", worst {worst:.2f} dB" if unequal else "")
                + (" (port: must be 0)" if own else " (library)"))
            require(not (own and unequal), f"[batch] {name}: {kname}: "
                    f"{unequal} of {calls} calls depend on the batch")

    with tempfile.TemporaryDirectory() as tmp:
        cfg_i8 = production_eval_cfg(load_config(_int8_store_config(
            os.path.join(tmp, "audio_int8.yml"))), cfg)
    routes = (("production (bf16, int8 taps)",
               production_eval_cfg(config, cfg)),
              ("int8 storage (bf16, act_store int8, strided_int8)", cfg_i8),
              ("bf16 float taps", dataclasses.replace(cfg,
                                                      dtype=torch.bfloat16)),
              ("fp32 float taps", cfg))
    for name, c in routes:
        p = prepare_params(params, c)
        with _BatchProbe(2) as probe:
            both = apply_model_flat_io(p, xf2, t2, c)
        report(name, probe)
        alone = [apply_model_flat_io(p, xf2[j:j + 1], t2[j:j + 1], c)
                 for j in range(2)]
        log(f"[batch] {name}: the whole forward, each clip at B = 1 vs "
            f"B = 2: bit-equal "
            f"{[torch_equal(alone[j], both[j:j + 1]) for j in range(2)]}, "
            "SNR " + ", ".join(
                f"{snr_db(from_flat(alone[j]), from_flat(both[j:j + 1])):.2f}"
                for j in range(2)) + " dB")
        del p, both, alone
    with _BatchProbe(2) as probe:
        apply_model(params, x2, t2, plain_cfg(cfg))
    report("plain route fp32", probe)
    # one torch.sum over a batch against the statistics sums' kernel, at the
    # main path's shapes: each stage's bf16 conv3x3 partials [B, tiles, 2·C]
    # and each stage's bf16 activation [B, T·F, C] (the glue's channel sums)
    cases = []
    for tt, f, cc in STAGES:
        tiles = conv3x3_plan(tt, f, cc, True, 2).tiles
        cases.append((f"partials [2, {tiles}, 2·{cc}]", (2, tiles, 2 * cc),
                      torch.float32, False))
    cases += [(f"activation [2, {tt}·{f}, {cc}] bf16", (2, tt * f, cc),
               torch.bfloat16, True) for tt, f, cc in STAGES]
    for label, shape, dtype, squares in cases:
        part = torch.randn(shape, device="cuda").to(dtype)
        ref = torch.stack([part.double().sum(dim=1)]
                          + ([part.double().square().sum(dim=1)] if squares
                             else []), dim=1)
        mine = batch_sums(part, squares)
        alone = [batch_sums(part[j:j + 1], squares) for j in range(2)]
        eq_mine = [torch_equal(alone[j], mine[j:j + 1]) for j in range(2)]
        tot = part.sum(dim=1, dtype=torch.float32)
        eq_torch = [torch_equal(part[j:j + 1].sum(dim=1, dtype=torch.float32),
                                tot[j:j + 1]) for j in range(2)]
        err = float(((mine.double() - ref).abs().amax(dim=-1)
                     / ref.abs().amax(dim=-1)).max())
        ms = cuda_time(lambda: batch_sums(part, squares), prefill=True)
        lib_ms = cuda_time(lambda: part.sum(dim=1, dtype=torch.float32),
                           prefill=True)
        log(f"[batch] {label} summed over its middle axis"
            f"{' (and its squares)' if squares else ''}, B = 1 vs B = 2's "
            f"slice bit-equal: one torch.sum {eq_torch}, batch_sums "
            f"{eq_mine}; batch_sums vs fp64 max rel {err:.1e} (<= "
            f"{TOL_BATCH_SUMS}); card ms at B = 2: batch_sums {ms:.4f} (all "
            f"its passes), one torch.sum of the values {lib_ms:.4f}")
        require(all(eq_mine), f"batch_sums depends on the batch at {label}")
        require(err <= TOL_BATCH_SUMS, f"batch_sums off by {err:.1e} at "
                f"{label}")


def _parallel_rank(rank, world, init):
    """One of the two ranks of the [parallel] phase, on cuda:0 in a gloo
    group. Rank 0 prints and holds the results; a failure on either rank
    ends both."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        _parallel_body(rank)
    finally:
        dist.destroy_process_group()


def _parallel_body(rank):
    import copy
    from types import SimpleNamespace

    import torch
    import torch.distributed as dist

    from ddim_audio_tpu_torch.config import production_eval_cfg
    from ddim_audio_tpu_torch.diffusion.schedules import make_schedule
    from ddim_audio_tpu_torch.models.unet import (apply_model_flat_io,
                                                  flat_io_adapters,
                                                  prepare_params)
    from ddim_audio_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                          train_update)
    from ddim_audio_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
    from ddim_audio_tpu_torch.parallel.sp import (apply_model_sp,
                                                  apply_model_sp_local,
                                                  sp_sampling_bundle)
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
    from ddim_audio_tpu_torch.tools import audio_model, forward_input
    from ddim_audio_tpu_torch.training.train_step import (init_train_state,
                                                          make_train_step)
    from ddim_audio_tpu_torch.utils.namespace import dict2namespace
    from ddim_audio_tpu_torch.weights import flatten_train_state

    say = log if rank == 0 else (lambda msg: None)
    config, cfg, params = audio_model()
    x, t = forward_input(cfg)
    cfg_prod = production_eval_cfg(config, cfg)
    sp2 = make_mesh(dict2namespace({"dp": 1, "sp": 2}))
    dp2 = make_mesh(dict2namespace({"dp": 2, "sp": 1}))
    to_flat, from_flat = flat_io_adapters(cfg)
    xf = to_flat(x).contiguous()
    say(f"[parallel] 2 ranks on cuda:0, sp = 2 and dp = 2 meshes; audio.yml "
        f"seed-made weights (non-zero GN3), x [1, 2, 8192, 256] (T_loc = 4096)")

    # 0. what one collective of the port costs on this group: an sp halo's
    # all-gather (64 KB) and a dp step's gradient all-reduce (188 MB, the
    # fp32 parameters of audio.yml)
    dev = torch.device("cuda", 0)
    halo = torch.randn((1, 2, 8192), device=dev)
    parts = [torch.empty_like(halo) for _ in range(2)]
    grads = torch.randn((47_000_000,), device=dev)
    costs = {}
    for label, n, fn in (("all-gather 64 KB", 50,
                          lambda: dist.all_gather(parts, halo)),
                         ("all-reduce 188 MB", 3,
                          lambda: dist.all_reduce(grads))):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        costs[label] = (time.perf_counter() - t0) / n * 1e3
    say("[parallel] one gloo collective on CUDA tensors, host ms (copies "
        "through host memory and the wait for the other rank): "
        + ", ".join(f"{k} {v:.3f}" for k, v in costs.items()))
    del halo, parts, grads

    # 1. the sp = 2 forward against the single-device kernel forward, then
    # each of its kernel calls on the haloed blocks against the kernel's twin
    # on the same operands (fp32: the [grad] phase's fp32 call floor)
    fp32 = {}
    for name, c, floor, want, shadow_db in (
            ("fp32 float taps", cfg, SNR_SP_FP32_DB, PER_SHARD_FLOAT,
             SHADOW_GRAD_FP32_DB),
            ("production (bf16, int8 taps)", cfg_prod, SNR_SP_PROD_DB,
             PER_SHARD_PROD, None)):
        packed = sp_sampling_bundle(params, c, sp2, x.shape[2])
        torch.cuda.synchronize()
        dist.barrier()
        reset_launch_counts()
        out = apply_model_sp(params, x, t, c, sp2, packed=packed)
        torch.cuda.synchronize()
        counts = forward_counts()
        require(counts == want, f"rank {rank} sp {name}: launches {counts} "
                f"!= {want}")
        require(bool(torch.isfinite(out).all()), f"sp {name} not finite")
        xl, tl = shard_batch(sp2, x, time_axis=2), shard_batch(sp2, t)
        with _CollectiveClock() as clock:
            ms_sp = _timed(lambda: apply_model_sp_local(packed, xl, tl, c,
                                                        sp2), clock=clock)
        coll_n, coll_ms = clock.calls / 3, clock.seconds * 1e3 / 3
        shadow = Shadow()
        with reference_route(shadow=shadow):
            apply_model_sp(params, x, t, c, sp2, packed=packed)
        shadow.check(f"[parallel] sp = 2 shard {rank}, {name},", want,
                     floor_db=shadow_db)
        dist.barrier()
        if rank == 0:
            p1 = prepare_params(params, c)
            ref = from_flat(apply_model_flat_io(p1, xf, t, c))
            snr, (d, rel) = snr_db(out, ref), rel_err(out, ref)
            ms_one = _timed(lambda: apply_model_flat_io(p1, xf, t, c))
            whole = Mesh(dp=1, sp=1, rank=0)
            ms_route = _timed(lambda: apply_model_sp_local(packed, x, t, c,
                                                           whole))
            log(f"[parallel] sp = 2 forward, {name}, vs the single-device "
                f"kernel forward: SNR {snr:.2f} dB (>= {floor}), max|diff| "
                f"{d:.3e} ({rel:.2e} of max) | launches per shard {counts}")
            log(f"[parallel] sp = 2 forward, {name}, ms per forward (host "
                f"pace, mean of 3): sp = 2 shard {ms_sp:.1f} (both ranks on "
                f"the one card at once), of which {coll_ms:.1f} "
                f"({coll_ms / ms_sp:.0%}) in {coll_n:.0f} collectives "
                f"({coll_ms / max(coll_n, 1):.2f} ms each, the wait for the "
                f"other rank included); the sp route on one rank over the "
                f"whole clip (no collectives) {ms_route:.1f}; single-device "
                f"kernel forward {ms_one:.1f}")
            require(snr >= floor, f"sp {name}: SNR {snr:.2f} < {floor} dB")
            if not fp32:
                fp32.update(sp=out, one=ref)
            else:
                sp_vs, one_vs = snr_db(out, fp32["sp"]), snr_db(ref, fp32["one"])
                log(f"[parallel] {name} vs fp32 float taps: sp = 2 "
                    f"{sp_vs:.2f} dB (>= {SNR_FWD_PROD_GN3_DB}, the "
                    f"single-device production guard), single-device "
                    f"{one_vs:.2f} dB")
                require(sp_vs >= SNR_FWD_PROD_GN3_DB, f"sp {name} vs fp32: "
                        f"SNR {sp_vs:.2f} < {SNR_FWD_PROD_GN3_DB} dB")
            del p1, ref
        dist.barrier()
        del packed, out

    # 2. and 3. the runner: 4 DDIM steps on sp = 2 and on dp = 2 against one
    # device's run of the same 2-clip batch (audio.yml's num_samples)
    steps = 4
    clips = config.sampling.num_samples
    with tempfile.TemporaryDirectory() as tmp:
        def sample(dp, sp, label):
            conf = copy.deepcopy(config)
            conf.parallel = dict2namespace({"dp": dp, "sp": sp})
            folder = os.path.join(tmp, label)
            args = SimpleNamespace(seed=1234, timesteps=steps,
                                   skip_type="uniform", eta=0.0,
                                   sample_type="generalized",
                                   image_folder=folder)
            runner = Diffusion(args, conf, device="cuda:0")
            reset_launch_counts()
            t0 = time.perf_counter()
            out = runner.sample_last_only(params)
            wall = time.perf_counter() - t0
            files = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
            return out, forward_counts(), files, wall

        want_files = sorted(f"{j}_final{e}" for j in range(clips)
                            for e in (".png", ".wav"))
        runs = {}
        for label, dp, sp, per in (("sp", 1, 2, PER_SHARD_PROD),
                                   ("dp", 2, 1, PER_FORWARD_PROD)):
            out, counts, files, wall = sample(dp, sp, label)
            fwd = steps  # a forward a step: sp runs both clips in one
            want = {k: v * fwd for k, v in per.items()}
            require(counts == want, f"rank {rank} {label} = 2 sampling: "
                    f"launches {counts} != {want}")
            require(files == (want_files if rank == 0 else []),
                    f"rank {rank} {label} = 2 sampling wrote {files}")
            require(out.shape == (clips, 2, 8192, 256)
                    and bool(np.isfinite(out).all()),
                    f"{label} = 2 sampling: {out.shape}, finite "
                    f"{np.isfinite(out).all()}")
            runs[label] = (out, counts, wall)
            dist.barrier()
        if rank == 0:
            ref, counts1, _, wall1 = sample(1, 1, "one")
            log(f"[parallel] runner sample_last_only, production config, "
                f"{clips} clips, {steps} DDIM steps: one device {wall1:.2f} s "
                f"host wall | launches {counts1}")
            for label, floor in (("sp", SNR_SP_CHAIN_DB),
                                 ("dp", SNR_DP_CHAIN_DB)):
                out, counts, wall = runs[label]
                snrs = [snr_db(torch.from_numpy(out[j]),
                               torch.from_numpy(ref[j])) for j in range(clips)]
                d = float(np.abs(out - ref).max())
                log(f"[parallel] runner on {label} = 2 vs one device: clip "
                    f"SNR {', '.join(f'{s:.2f}' for s in snrs)} dB (>= "
                    f"{floor}), max|diff| {d:.3e}; rank 0 wrote "
                    f"{len(want_files)} files, rank 1 none; {wall:.2f} s host "
                    f"wall | launches per rank {counts}")
                require(min(snrs) >= floor, f"{label} = 2 sampling: SNR "
                        f"{min(snrs):.2f} < {floor} dB")
        dist.barrier()

    # 4. one fp32 dp = 2 training step against one device's grad_accum 2
    alphas = make_schedule("linear", 1e-4, 0.02, 1000).alphas_cumprod
    gen_x = torch.Generator().manual_seed(11)
    x0 = (0.5 * torch.randn((2, cfg.channels, 1024, cfg.f_size),
                            generator=gen_x)).cuda()

    def one_step(accum, mesh):
        conf = copy.deepcopy(config)
        conf.training.grad_accum = accum
        state, tx = init_train_state(copy.deepcopy(params),
                                     conf.optimization, use_ema=True)
        step = make_train_step(cfg, conf, alphas, tx, mesh=mesh)
        gen = torch.Generator("cuda").manual_seed(5)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, x0, gen)
        torch.cuda.synchronize()
        updates = train_update.train_update.launches
        require(updates == UPDATE_LAUNCHES, f"rank {rank} train step (grad_"
                f"accum {accum}, dp {1 if mesh is None else mesh.dp}): the "
                f"one-pass update launched {updates}")
        return state, metrics, launch_counts(), time.perf_counter() - t0

    one_step(1, dp2)  # warm-up: the first step on a rank initialises
    state, metrics, counts, wall = one_step(1, dp2)
    require(counts == PER_MICROBATCH, f"rank {rank} dp step: launches "
            f"{counts} != {PER_MICROBATCH}")
    dist.barrier()
    if rank == 0:
        one_step(2, None)  # warm-up
        ref, ref_metrics, _, wall1 = one_step(2, None)
        flat, flat_ref = flatten_train_state(state), flatten_train_state(ref)
        require(flat.keys() == flat_ref.keys(), "train state keys differ")
        worst, worst_key, equal = 0.0, "", 0
        for k, b in flat_ref.items():
            a = np.asarray(flat[k], np.float64)
            b = np.asarray(b, np.float64)
            equal += int(np.array_equal(a, b))
            scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
            rel = float(np.abs(a - b).max(initial=0.0)) / scale
            if rel > worst:
                worst, worst_key = rel, k
        log(f"[parallel] fp32 dp = 2 train step (a microbatch [1, 2, 1024, "
            f"256] a rank) vs one device's grad_accum 2 step: loss "
            f"{float(metrics['loss']):.6f} vs {float(ref_metrics['loss']):.6f}"
            f", {equal} of {len(flat_ref)} leaves bit-equal, worst leaf "
            f"{worst:.2e} of its scale (<= {TOL_DP_STEP}) {worst_key} | "
            f"{wall:.2f} s (two ranks on the one card at once) vs "
            f"{wall1:.2f} s host wall | launches per rank {counts}")
        require(worst <= TOL_DP_STEP, f"dp step: {worst_key} off by {worst:.2e}")
    dist.barrier()
    del state, x0
    torch.cuda.empty_cache()

    # 5. one fp32 sp = 2 training step against one device's step
    _parallel_sp_train(rank, config, cfg, params, sp2)


def _leaf_gaps(flat, flat_ref, keep, scale_of):
    """(worst max|a − b| / scale over the leaves whose key ``keep`` takes,
    its key, the leaves compared); ``scale_of(key, b)`` gives a leaf's
    scale."""
    worst, worst_key, n = 0.0, "", 0
    for k, b in flat_ref.items():
        if not keep(k):
            continue
        a = np.asarray(flat[k], np.float64)
        b = np.asarray(b, np.float64)
        rel = float(np.abs(a - b).max(initial=0.0)) / scale_of(k, b)
        n += 1
        if rel > worst:
            worst, worst_key = rel, k
    return worst, worst_key, n


def _move_gaps(flat, flat_ref, before, prefix):
    """One step's moves (after − before) of the leaves under ``prefix``
    against the reference's, entry by entry. An entry passes within
    TOL_GRAD_LEAF of its leaf's largest reference move (floored at 1e-3 of
    the largest of all) plus one fp32 unit in the last place of its
    reference value: at step 0 the warm-up's learning rate makes a move a
    few units of a weight or less (the EMA's far less), so an update that
    differs in its last bits rounds p + u to the neighbouring value.
    Returns (the worst gap over its scale without the unit, its key, the
    leaves, the entries that needed the unit, the entries beyond it, all
    entries)."""
    keys = [k for k in flat_ref if k.startswith(prefix)]
    ref = {k: np.asarray(flat_ref[k], np.float64)
           - np.asarray(before[k], np.float64) for k in keys}
    top = max(float(np.abs(v).max(initial=0.0)) for v in ref.values())
    worst, worst_key, ulp_n, bad_n, entries = 0.0, "", 0, 0, 0
    for k in keys:
        scale = max(float(np.abs(ref[k]).max(initial=0.0)), 1e-3 * top)
        gap = np.abs(np.asarray(flat[k], np.float64)
                     - np.asarray(flat_ref[k], np.float64))
        unit = np.spacing(np.abs(np.asarray(flat_ref[k], np.float32)))
        tol = TOL_GRAD_LEAF * scale
        rel = float(gap.max(initial=0.0)) / scale
        if rel > worst:
            # the leaf's largest move in fp32 units of its largest value
            top_unit = float(np.spacing(np.float32(np.abs(flat_ref[k]).max(
                initial=0.0))))
            worst = rel
            worst_key = f"{k} (moves up to {scale / top_unit:.1f} units)"
        ulp_n += int(((gap > tol) & (gap <= tol + unit)).sum())
        bad_n += int((gap > tol + unit).sum())
        entries += gap.size
    return worst, worst_key, len(keys), ulp_n, bad_n, entries


def _parallel_sp_train(rank, config, cfg, params, sp2):
    """[parallel] 5: one fp32 sp = 2 training step of audio.yml's model at
    [2, 2, 1024, 256] (each rank a [2, 2, 512, 256] block, grad_accum 1,
    injected timesteps and noise) against one device's step on the same
    draws; its kernel calls against their twins; what it costs."""
    import copy

    import torch
    import torch.distributed as dist

    from ddim_audio_tpu_torch.diffusion.schedules import make_schedule
    from ddim_audio_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                          train_update)
    from ddim_audio_tpu_torch.training.train_step import (init_train_state,
                                                          make_train_step)
    from ddim_audio_tpu_torch.weights import flatten_train_state

    say = log if rank == 0 else (lambda msg: None)
    alphas = make_schedule("linear", 1e-4, 0.02, 1000).alphas_cumprod
    gen = torch.Generator().manual_seed(12)
    shape = (2, cfg.channels, 1024, cfg.f_size)
    x0 = (0.5 * torch.randn(shape, generator=gen)).cuda()
    draws = (torch.tensor([500, 120], device="cuda"),
             torch.randn(shape, generator=gen).cuda())
    conf = copy.deepcopy(config)
    conf.training.grad_accum = 1

    def run(mesh, clock=None, fused=True):
        """(state before, state after, metrics, launches, CUDA-event ms,
        host ms) of one step from a fresh state; ``fused``: its update in
        the one-pass kernel (the twin route: leaf by leaf)."""
        state, tx = init_train_state(copy.deepcopy(params), conf.optimization,
                                     use_ema=True)
        before = flatten_train_state(state)
        step = make_train_step(cfg, conf, alphas, tx, mesh=mesh)
        torch.cuda.synchronize()
        if mesh is not None:
            dist.barrier()
        reset_launch_counts()
        if clock is not None:
            clock.calls, clock.seconds = 0, 0.0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, metrics = step(state, x0, None, noise_override=draws)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        updates = train_update.train_update.launches
        require(updates == UPDATE_LAUNCHES * fused, f"rank {rank} train "
                f"step ({'one device' if mesh is None else 'sp = 2'}): the "
                f"one-pass update launched {updates}")
        return (before, state, metrics, launch_counts(),
                start.elapsed_time(end), wall)

    say(f"[parallel] sp = 2 training step: audio.yml, fp32, remat, "
        f"x0 {list(shape)} (a rank's block [2, 2, 512, 256]; haloed blocks "
        "of 514, 258, 130, 66, 34, 18 rows), grad_accum 1, t [500, 120] and "
        "the noise injected, non-zero GN3 weights")
    run(sp2)  # warm-up: the first step on a rank initialises
    with _CollectiveClock() as clock:
        before, state, metrics, counts, ms, wall = run(sp2, clock)
    coll_n, coll_ms = clock.calls, clock.seconds * 1e3
    require(counts == PER_SHARD_TRAIN, f"rank {rank} sp step: launches "
            f"{counts} != {PER_SHARD_TRAIN}")
    shadow = Shadow()
    with reference_route(shadow=shadow):
        run(sp2, fused=False)
    shadow.check(f"[parallel] sp = 2 train step, shard {rank}, fp32,",
                 PER_SHARD_TRAIN, floor_db=SHADOW_GRAD_FP32_DB)
    dist.barrier()
    if rank == 0:
        run(None)  # warm-up
        _, ref, ref_metrics, counts1, ms1, wall1 = run(None)
        flat, flat_ref = flatten_train_state(state), flatten_train_state(ref)
        require(flat.keys() == flat_ref.keys(), "train state keys differ")
        loss, loss1 = float(metrics["loss"]), float(ref_metrics["loss"])
        loss_rel = abs(loss - loss1) / abs(loss1)
        # the gradients: the first moments after one step, (1 - beta1)·g
        mu = [k for k in flat_ref if ".mu[" in k]
        mu_max = max(float(np.abs(flat_ref[k]).max()) for k in mu)
        g_worst, g_key, g_n = _leaf_gaps(
            flat, flat_ref, lambda k: ".mu[" in k,
            lambda k, b: max(float(np.abs(b).max(initial=0.0)),
                             1e-3 * mu_max))
        # the second moments (AdaBelief's s, AdamW's nu): squares of the
        # gradients, so their floor is the square of the gradients' 1e-3
        second = [k for k in flat_ref if ".s[" in k or ".nu[" in k]
        nu_max = max(float(np.abs(flat_ref[k]).max()) for k in second)
        n_worst, n_key, n_n = _leaf_gaps(
            flat, flat_ref, lambda k: ".s[" in k or ".nu[" in k,
            lambda k, b: max(float(np.abs(b).max(initial=0.0)),
                             1e-6 * nu_max))
        moves = {kind: _move_gaps(flat, flat_ref, before, kind)
                 for kind in (".params", ".ema")}
        log(f"[parallel] fp32 sp = 2 train step vs one device's step, same "
            f"draws: loss {loss:.6f} vs {loss1:.6f} (rel {loss_rel:.2e} <= "
            f"{TOL_SP_LOSS}); {g_n} gradient leaves, worst {g_worst:.2e} of "
            f"its scale (<= {TOL_GRAD_LEAF}) at {g_key}; {n_n} second-moment "
            f"leaves, worst {n_worst:.2e} (<= {TOL_GRAD_LEAF}) at {n_key}")
        for kind, (worst, key, leaves, ulp_n, bad_n, entries) in moves.items():
            log(f"[parallel] sp step, {kind[1:]}: {leaves} leaves, "
                f"{entries} entries, each one's move held within "
                f"{TOL_GRAD_LEAF} of its leaf's scale plus one fp32 unit of "
                f"its value: {bad_n} beyond; {ulp_n} needed the unit (<= "
                f"{TOL_SP_ULP_SHARE:g} of the entries); worst without the "
                f"unit {worst:.2e} of its scale at {key}")
            require(bad_n == 0, f"sp step: {bad_n} {kind[1:]} entries off by "
                    f"more than {TOL_GRAD_LEAF} of the scale and one unit")
            require(ulp_n <= TOL_SP_ULP_SHARE * entries, f"sp step: {ulp_n} "
                    f"of {entries} {kind[1:]} entries one unit apart")
        log(f"[parallel] sp = 2 train step, ms: CUDA events {ms:.1f}, host "
            f"wall {wall:.1f} a shard (both ranks on the one card at once), "
            f"of which {coll_ms:.1f} ({coll_ms / wall:.0%}) in {coll_n} "
            f"collectives ({coll_ms / max(coll_n, 1):.2f} ms each, the wait "
            f"for the other rank included); one device's step {ms1:.1f} "
            f"(CUDA events), {wall1:.1f} host wall | launches per shard "
            f"{counts}, one device {counts1}")
        require(loss_rel <= TOL_SP_LOSS, f"sp step: loss rel {loss_rel:.2e}")
        require(g_worst <= TOL_GRAD_LEAF, f"sp step: gradient of {g_key} off "
                f"by {g_worst:.2e} of its scale")
        require(n_worst <= TOL_GRAD_LEAF, f"sp step: second moment of "
                f"{n_key} off by {n_worst:.2e} of its scale")
    dist.barrier()


def phase_parallel():
    """[parallel]: the mesh's refusal in one plain process, then two gloo
    ranks on the one card: the sp = 2 forward, the runner on sp = 2 and
    dp = 2, the dp = 2 training step."""
    import torch
    import torch.multiprocessing as mp

    _parallel_cli_refusal()
    log("[parallel] backend: gloo, 2 ranks on cuda:0 (NCCL refuses two ranks "
        "on one device; gloo runs all_reduce, all_gather and broadcast on "
        "CUDA tensors, the only collectives the port issues)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_parallel_rank,
                           args=(2, "file://" + os.path.join(tmp, "rdzv")),
                           nprocs=2, join=True, start_method="spawn")
    log(f"[parallel] done in {time.perf_counter() - t0:.1f} s (spawn "
        "included)")


def main() -> int:
    import torch

    summary = {}
    try:
        card = phase_device()
        phase_build()
        phase_kernels(summary)
        phase_int8_kernels(summary)
        phase_dw_kernels(summary)
        phase_train_kernels()
        phase_train_update()
        config, cfg, params = _audio_params()
        phase_forward(config, cfg, params)
        phase_batch(config, cfg, params)
        phase_slice(summary, params)
        phase_float_path(summary, config, cfg, params)
        phase_int8_store(summary, cfg, params)
        phase_grad(cfg, params)
        del params
        torch.cuda.empty_cache()
        phase_train(summary)
        phase_parallel()
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        log(f"[FAIL] {type(e).__name__}: {e}")
        return 1
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, **summary[name]})
    log(f"[card] {card} (every number above was measured on it)")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
