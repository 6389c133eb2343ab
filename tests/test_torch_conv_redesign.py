"""Index math of the bf16 tensor-core conv3x3 and up-conv kernels, on the CPU
(the down conv and the int8-tap conv3x3: tests/test_torch_down_int8_redesign.py).

The CUDA kernels (``csrc/conv3x3.cu`` ``conv3x3_mma_kernel``,
``csrc/conv_strided.cu`` ``conv_up_mma_kernel``) run only on the card. What
surrounds their arithmetic is checked here:

- the tile plans of the redesigned kernels: the Python model
  (``ops/tile_plan.py``, which the wrappers use to size the statistics
  partials) against the C functions of ``csrc/conv_plan.cu``, built by the
  host compiler;
- numpy models of the two kernels' blocks, walking the grid of the plan as
  the kernels do (halo offsets, tap choice, parity classes, output-channel
  groups over grid.z, ragged edges, per-tile statistics partials), against
  the plain twins in fp64 and, for the sub-pixel up conv, against the JAX
  package's ``conv_up_flat`` in Pallas interpret mode.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.ops.pallas.conv_strided import (
    conv_up_flat as jax_conv_up,
    pack_up_weights,
)
from ddim_audio_tpu_torch.ops.conv_flat import _prologue, conv3x3_flat_plain
from ddim_audio_tpu_torch.ops.conv_strided import conv_up_flat_plain
from ddim_audio_tpu_torch.ops.tile_plan import (
    VARIANT_FMA,
    VARIANT_MMA,
    VARIANT_NONE,
    VARIANT_TF32,
    TilePlan,
    conv3x3_dw_plan,
    conv3x3_int8_plan,
    conv3x3_plan,
    conv3x3_store_plan,
    conv_down_dw_plan,
    conv_down_int8_plan,
    conv_down_plan,
    conv_head_plan,
    conv_tail_plan,
    conv_up_dw_plan,
    conv_up_int8_plan,
    conv_up_plan,
    dw_tf32_threads,
    library_plan,
    residual_affine_plan,
)

torch.set_num_threads(2)
CSRC = Path(__file__).resolve().parent.parent / "ddim_audio_tpu_torch" / "csrc"

# audio.yml stages (T, F, C) and up transitions (T_in, F_in, C_in, C_out)
STAGES = [(8192, 256, 32), (4096, 128, 64), (2048, 64, 96), (1024, 32, 128),
          (512, 16, 192), (256, 8, 256)]
UPS = [(4096, 128, 64, 32), (2048, 64, 96, 64), (1024, 32, 128, 96),
       (512, 16, 192, 128), (256, 8, 256, 192)]
# down transitions (T_in, F_in, C_in, C_out) and the int8-tap stages (T, F, C)
DOWNS = [(8192, 256, 32, 64), (4096, 128, 64, 96), (2048, 64, 96, 128),
         (1024, 32, 128, 192), (512, 16, 192, 256)]
INT8_STAGES = STAGES[:3]
STORE_STAGES = STAGES[:4]  # the stages that store int8 activations
# the training transitions (one microbatch [1, 2, 1024, 256]), which run the
# fp32 down conv, and the up transitions with int8 taps (T_in, F_in, C_in,
# C_out)
TRAIN_DOWNS = [(1024, 256, 32, 64), (512, 128, 64, 96), (256, 64, 96, 128),
               (128, 32, 128, 192), (64, 16, 192, 256)]
# ... and its stages (T, F, C) and up transitions, which run the fp32 conv3x3
# and up convs
TRAIN_STAGES = [(1024, 256, 32), (512, 128, 64), (256, 64, 96), (128, 32, 128),
                (64, 16, 192), (32, 8, 256)]
TRAIN_UPS = [(512, 128, 64, 32), (256, 64, 96, 64), (128, 32, 128, 96),
             (64, 16, 192, 128), (32, 8, 256, 192)]
UPS_I8 = [(4096, 128, 64, 32), (256, 8, 256, 192)]
# sequence-parallel training at sp = 2: each stage's time block of T / 2
# rows with one halo row a side, the rows the fp32 conv3x3 (forward and dx)
# and its weight gradient run on (514 … 18)
SP_TRAIN_STAGES = [(t // 2 + 2, f, c) for t, f, c in TRAIN_STAGES]


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/conv_plan.cu")
    lib_path = tmp_path_factory.mktemp("plan") / "libconv_plan.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-o", str(lib_path), str(CSRC / "conv_plan.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, n in (("ddim_conv3x3_plan", 5), ("ddim_conv_up_plan", 6),
                    ("ddim_conv_down_plan", 6), ("ddim_conv_up_int8_plan", 6),
                    ("ddim_conv3x3_int8_plan", 5),
                    ("ddim_conv3x3_store_plan", 6), ("ddim_conv_head_plan", 6),
                    ("ddim_conv_tail_plan", 6),
                    ("ddim_conv_down_int8_plan", 6),
                    ("ddim_conv_down_dw_plan", 6),
                    ("ddim_conv3x3_dw_plan", 6), ("ddim_conv_up_dw_plan", 6),
                    ("ddim_residual_affine_plan", 6)):
        getattr(lib, name).argtypes = [ctypes.c_int] * n + [ctypes.c_void_p]
    lib.ddim_dw_tf32_threads.argtypes = [ctypes.c_int]
    return lib


def test_tile_plans_match_the_c_plans(plan_lib):
    """Every production shape (B = 1, 2; bf16 and fp32) and a sweep of small
    and ragged ones: variant, tile, tiles, groups, split, shared memory and
    grid as conv_plan.h computes them; the production bf16 calls all take
    the tensor-core variant, the fp32 conv3x3, up and down ones (and the
    three weight gradients) split TF32 on the tensor cores; the int8 down
    conv is persistent."""
    c3 = [(t, f, c) for t in (1, 7, 16, 33) for f in (1, 8, 12, 16, 40)
          for c in (16, 32, 48, 64, 96, 128, 192, 256, 512, 1024)] + STAGES \
        + TRAIN_STAGES + SP_TRAIN_STAGES
    assert [t for t, _, _ in SP_TRAIN_STAGES] == [514, 258, 130, 66, 34, 18]
    for t, f, c in c3:
        for bf16 in (0, 1):
            for b in (1, 2, 5):
                want = library_plan(plan_lib.ddim_conv3x3_plan, t, f, c,
                                    bf16, b)
                assert conv3x3_plan(t, f, c, bool(bf16), b) == want, (t, f, c)
                assert plan_lib.ddim_conv3x3_tiles(t, f, c, bf16) == want.tiles
                assert plan_lib.ddim_conv3x3_variant(t, f, c, bf16) == \
                    want.variant
    ups = [(t, f, ci, co) for t in (1, 6, 9) for f in (1, 8, 12, 20)
           for ci, co in ((32, 32), (48, 32), (64, 48), (256, 192),
                          (1024, 64))] + UPS + TRAIN_UPS
    for t, f, ci, co in ups:
        for bf16 in (0, 1):
            for b in (1, 2, 3):
                want = library_plan(plan_lib.ddim_conv_up_plan, t, f, ci, co,
                                    bf16, b)
                assert conv_up_plan(t, f, ci, co, bool(bf16), b) == want
                assert plan_lib.ddim_conv_up_tiles(t, f, ci, co, bf16) == \
                    want.tiles
                assert plan_lib.ddim_conv_up_variant(t, f, ci, co, bf16) == \
                    want.variant
    downs = [(t, f, ci, co) for t in (2, 6, 18, 34) for f in (2, 16, 18, 34)
             for ci, co in ((32, 64), (64, 96), (96, 128), (128, 192),
                            (192, 256), (32, 96), (48, 64), (64, 48),
                            (512, 512))] + DOWNS + TRAIN_DOWNS
    for t, f, ci, co in downs:
        for bf16 in (0, 1):
            for b in (1, 2, 3):
                want = library_plan(plan_lib.ddim_conv_down_plan, t, f, ci, co,
                                    bf16, b)
                assert conv_down_plan(t, f, ci, co, bool(bf16), b) == want
                assert plan_lib.ddim_conv_down_tiles(t, f, ci, co, bf16) == \
                    want.tiles
                assert plan_lib.ddim_conv_down_variant(t, f, ci, co, bf16) == \
                    want.variant
    up_i8 = [(t, f, ci, co) for t in (1, 3, 4, 9) for f in (1, 7, 8, 20)
             for ci, co in ((32, 32), (64, 32), (256, 192), (96, 64),
                            (288, 32), (48, 32), (64, 48))] + UPS_I8
    for t, f, ci, co in up_i8:
        for bf16 in (0, 1):
            for b in (1, 2):
                want = library_plan(plan_lib.ddim_conv_up_int8_plan, t, f, ci,
                                    co, bf16, b)
                assert conv_up_int8_plan(t, f, ci, co, bool(bf16), b) == want
                assert want.variant == (
                    VARIANT_MMA if ci % 32 == 0 and ci <= 256 and co % 32 == 0
                    else VARIANT_NONE), (t, f, ci, co)
    i8 = [(t, f, c) for t in (1, 8, 9, 33) for f in (1, 16, 17, 40)
          for c in (16, 32, 64, 96, 128)] + INT8_STAGES
    for t, f, c in i8:
        for bf16 in (0, 1):
            for b in (1, 2):
                want = library_plan(plan_lib.ddim_conv3x3_int8_plan, t, f, c,
                                    bf16, b)
                assert conv3x3_int8_plan(t, f, c, bool(bf16), b) == want
                assert want.variant == (VARIANT_MMA if c in (32, 64, 96)
                                        else VARIANT_NONE)
    down_i8 = [(t, f, ci, co) for t in (2, 16, 18, 34) for f in (2, 16, 30, 66)
               for ci, co in ((32, 64), (64, 96), (64, 128), (32, 32),
                              (96, 128), (48, 64), (64, 48), (32, 512),
                              (256, 256), (288, 64))] \
        + [DOWNS[0]]
    for t, f, ci, co in down_i8:
        for bf16 in (0, 1):
            for b in (1, 2, 3):
                want = library_plan(plan_lib.ddim_conv_down_int8_plan, t, f,
                                    ci, co, bf16, b)
                assert conv_down_int8_plan(t, f, ci, co, bool(bf16), b) == \
                    want, (t, f, ci, co)
                # persistent (grid > 0) at C_in 32 and 64, else two-pass
                assert want.variant == (VARIANT_MMA if ci % 32 == 0
                                        and ci <= 256 and co % 32 == 0
                                        else VARIANT_NONE)
                assert (want.grid > 0) == (ci in (32, 64) and co % 32 == 0)
    down_dw = [(t, f, ci, co) for t in (2, 10, 16, 34) for f in (2, 8, 16, 34)
               for ci, co in ((32, 64), (64, 96), (96, 128), (192, 256),
                              (48, 64), (64, 48), (8, 32))] + TRAIN_DOWNS
    # the 3×3 conv's (C_in = C_out in the model; the kernel takes any) and
    # the up conv's, in x's geometry
    dw = {"down": (plan_lib.ddim_conv_down_dw_plan, conv_down_dw_plan,
                   down_dw),
          "3x3": (plan_lib.ddim_conv3x3_dw_plan, conv3x3_dw_plan,
                  [(t, f, c, c) for t in (1, 7, 16, 33) for f in (1, 8, 16, 20)
                   for c in (16, 32, 48, 64, 96, 192, 256)]
                  + [(12, 24, 32, 64), (12, 24, 64, 32)]
                  + [(t, f, c, c) for t, f, c in TRAIN_STAGES
                     + SP_TRAIN_STAGES]),
          "up": (plan_lib.ddim_conv_up_dw_plan, conv_up_dw_plan,
                 [(t, f, ci, co) for t in (1, 5, 8, 17) for f in (1, 8, 16, 18)
                  for ci, co in ((64, 32), (96, 64), (256, 192), (48, 32),
                                 (64, 48), (8, 32))] + TRAIN_UPS)}
    for query, model, shapes in dw.values():
        for t, f, ci, co in shapes:
            for bf16 in (0, 1):
                for b in (1, 2, 3):
                    want = library_plan(query, t, f, ci, co, bf16, b)
                    assert model(t, f, ci, co, bool(bf16), b) == want, \
                        (t, f, ci, co)
    assert [plan_lib.ddim_dw_tf32_threads(m) for m in (0, 1, 2)] == \
        [dw_tf32_threads(m) for m in (0, 1, 2)] == [192, 256, 256]
    st = [(t, f, c) for t in (1, 8, 9, 17, 33) for f in (1, 8, 16, 17, 40)
          for c in (16, 32, 48, 64, 96, 128, 192, 256, 480, 512)] + STORE_STAGES
    for t, f, c in st:
        for bf16 in (0, 1):
            for b in (1, 2, 5):
                for scaled in (0, 1, 2):
                    want = library_plan(plan_lib.ddim_conv3x3_store_plan, t, f,
                                        c, bf16, b, scaled)
                    assert conv3x3_store_plan(t, f, c, bool(bf16), b,
                                              scaled) == want, (t, f, c)
    for b in (1, 2):
        # the storage conv: the tensor cores at every storage stage in bf16
        # (one int8 operand, as the model runs it), CUDA cores in fp32
        assert all(conv3x3_store_plan(*s, True, b, 1).variant == VARIANT_MMA
                   for s in STORE_STAGES)
        assert all(conv3x3_store_plan(*s, False, b, 1).variant == VARIANT_FMA
                   for s in STORE_STAGES)
        # the tensor-core down conv at every transition, f_out = 8 included;
        # the int8 kernel's group is the 8 × 16 tile at every int8 stage
        assert all(conv_down_plan(*s, True, b).variant == VARIANT_MMA
                   for s in DOWNS)
        # fp32: split TF32 on the tensor cores at every transition, one
        # output-channel group a block; the int8-tap up conv: one partial a
        # quantisation group, 32 output channels a block
        for s in DOWNS + TRAIN_DOWNS:
            plan = conv_down_plan(*s, False, b)
            assert plan.variant == VARIANT_TF32
            assert plan.split % plan.groups == 0  # groups · the K split
        for t, f, ci, co in UPS_I8:
            for bf16 in (True, False):
                plan = conv_up_int8_plan(t, f, ci, co, bf16, b)
                assert plan[:3] == (VARIANT_MMA, 8, 16)
                assert plan.tiles == (2 * t // 8) * (2 * f // 16)
                assert plan.split == plan.groups == co // 32
        assert all(conv3x3_int8_plan(*s, bf16, b)[:3] == (VARIANT_MMA, 8, 16)
                   for s in INT8_STAGES for bf16 in (True, False))
        # the narrow grids share their groups over grid.z, 32→64 does not
        assert [conv_down_plan(*s, True, b).split for s in DOWNS] == \
            [1, 1, 3 - b, 3, 4]
        assert all(conv3x3_plan(*s, True, b).variant == VARIANT_MMA
                   for s in STAGES)
        assert all(conv_up_plan(*s, True, b).variant == VARIANT_MMA
                   for s in UPS)
        # fp32 conv3x3 and up: split TF32 on the tensor cores at every
        # stage and transition, sampling and training shapes (the sp
        # shards' haloed blocks too), one output-channel group a block
        # (split = groups · the K split)
        for s in STAGES + TRAIN_STAGES + SP_TRAIN_STAGES:
            plan = conv3x3_plan(*s, False, b)
            assert plan.variant == VARIANT_TF32
            assert plan.split % plan.groups == 0
        for s in UPS + TRAIN_UPS:
            plan = conv_up_plan(*s, False, b)
            assert plan.variant == VARIANT_TF32
            assert plan.split % plan.groups == 0
    # the head (T, F, Cin, C0) and tail (T, F, C0, Cout): the production
    # shape, chip_smoke.py's 40 x 24, and a ragged sweep
    sweep = [(t, f) for t in (1, 7, 33, 300, 8192)
             for f in (1, 5, 8, 13, 24, 40, 256, 600, 4096)]
    heads = [(t, f, ci, c0) for t, f in sweep for ci in (0, 1, 2, 3, 4, 5)
             for c0 in (8, 16, 32, 64)]
    tails = [(t, f, c0, co) for t, f in sweep
             for c0 in (16, 32, 64, 96, 128, 256) for co in (1, 2, 3, 4)]
    for kind, shapes, model in (("head", heads, conv_head_plan),
                                ("tail", tails, conv_tail_plan)):
        fn = getattr(plan_lib, f"ddim_conv_{kind}_plan")
        for shape in shapes:
            for bf16 in (0, 1):
                for b in (1, 2, 3):
                    want = library_plan(fn, *shape, bf16, b)
                    assert model(*shape, bool(bf16), b) == want, (kind, shape)
                    assert getattr(plan_lib, f"ddim_conv_{kind}_variant")(
                        *shape, bf16) == want.variant
    for b in (1, 2):
        for t, f in ((8192, 256), (40, 24)):
            # bf16 on the tensor cores, the fp32 head in split TF32 on
            # them, the fp32 tail on CUDA cores, both shapes
            head = conv_head_plan(t, f, 2, 32, True, b)
            tail = conv_tail_plan(t, f, 32, 2, True, b)
            head32 = conv_head_plan(t, f, 2, 32, False, b)
            assert head.variant == tail.variant == VARIANT_MMA
            assert head32.variant == VARIANT_TF32
            assert conv_tail_plan(t, f, 32, 2, False, b).variant == \
                VARIANT_FMA
            assert head.tile_f == tail.tile_f == head32.tile_f == f
        # one statistics partial a block, FILL_BLOCKS blocks a sample at
        # any batch (a clip's partials do not depend on its batch)
        assert conv_head_plan(8192, 256, 2, 32, True, b).tiles == 264
        # fp32: one row of 256 positions a tile, two blocks an SM
        head32 = conv_head_plan(8192, 256, 2, 32, False, b)
        assert head32.tiles == 264 and head32.tile_t == 1
        assert 2 * (head32.smem + 1024) <= 233_472
    # residual_affine (T, F, C, x kind, s kind: 0 fp32, 1 bf16, 2 int8): a
    # sweep of ragged shapes and every kind; at the storage stages in the
    # int8-storage forward's modes a persistent grid of at most four blocks
    # an SM over the channel groups at any batch (a sample's partials do not
    # depend on B), one partial a block
    res = [(t, f, c) for t in (1, 7, 8, 9, 33, 300) for f in (1, 8, 15, 16,
                                                              17, 40)
           for c in (16, 32, 64, 96, 128, 256, 1024)] + STORE_STAGES
    for t, f, c in res:
        for xk in (0, 1, 2):
            for sk in (0, 1, 2):
                for b in (1, 2, 3):
                    want = library_plan(plan_lib.ddim_residual_affine_plan, t,
                                        f, c, xk, sk, b)
                    assert residual_affine_plan(t, f, c, xk, sk, b) == want, \
                        (t, f, c, xk, sk, b)
                    assert want.variant == (VARIANT_FMA if c % 32 == 0
                                            else VARIANT_NONE)
    for t, f, c in STORE_STAGES:
        for b in (1, 2):
            for xk in (1, 2):  # a stage entry (bf16 x), an interior block
                plan = residual_affine_plan(t, f, c, xk, 2, b)
                assert plan.grid == plan.tiles < -(-t // 8) * -(-f // 16)
                assert plan.grid * plan.groups == 4 * 132
                assert plan[1:3] == (8, 16) and plan.groups == c // 32
    # two tail blocks an SM: bands of 32 rows
    assert conv_tail_plan(8192, 256, 32, 2, True, 1)[1:4] == (32, 256, 256)
    # fp32 down at the training shapes: 128 positions a block (256 at C_out
    # = 96) where a sample's grid reaches two blocks an SM, else half
    assert [conv_down_plan(*s, False, 1)[1:4] for s in TRAIN_DOWNS] == [
        (8, 16, 512), (8, 16, 128), (4, 16, 64), (4, 16, 16), (8, 8, 4)]
    # ... and the input channels split over a cluster of blocks where a
    # sample's grid stays under one block an SM (48 and 16 blocks)
    assert [conv_down_plan(*s, False, 1).split for s in TRAIN_DOWNS] == [
        1, 3, 2, 3 * 2, 4 * 6]
    # fp32 conv3x3 at the training shapes: 128 positions a block (MT = 2 at
    # C = 64, where two warps share 64 channels and two blocks fit an SM;
    # MT = 1 at C = 32 and 96) where a sample's grid reaches two blocks an
    # SM, else 64; the input channels split over a cluster where it stays
    # under one block an SM (s4: 48 blocks, s5: 16)
    assert [conv3x3_plan(*s, False, 1)[1:4] for s in TRAIN_STAGES] == [
        (8, 16, 2048), (8, 16, 512), (8, 16, 128), (4, 16, 64), (4, 16, 16),
        (8, 8, 4)]
    assert [conv3x3_plan(*s, False, 1).split for s in TRAIN_STAGES] == [
        1, 1, 3, 2, 3 * 2, 4 * 8]
    # fp32 up: 64 input positions a block (4 × 16, 8 × 8 at F_in = 8), the
    # K split at 192→128 (64 blocks) and 256→192 (24)
    assert [conv_up_plan(*s, False, 1)[1:4] for s in TRAIN_UPS] == [
        (4, 16, 1024), (4, 16, 256), (4, 16, 64), (4, 16, 16), (8, 8, 4)]
    assert [conv_up_plan(*s, False, 1).split for s in TRAIN_UPS] == [
        1, 2, 3, 4 * 2, 6 * 5]
    # s5 at B = 1 (16 tiles) shares its four groups over grid.z; s0 does not
    assert conv3x3_plan(256, 8, 256, True, 1).split == 4
    assert conv3x3_plan(8192, 256, 32, True, 1).split == 1
    assert conv_up_plan(256, 8, 256, 192, True, 1).split == 6
    # the int8 down conv at 32→64: 64 output channels a block, two blocks an
    # SM in bf16 (one in fp32), its grid one wave of them over 4,096 groups
    for b in (1, 2):
        assert conv_down_int8_plan(*DOWNS[0], True, b)[1:] == (
            8, 16, 4096, 1, 1, 95_648, 264)
        assert conv_down_int8_plan(*DOWNS[0], False, b).grid == 132
    # the fp32 down dW at the training shapes: split TF32, 64 base
    # positions a tile (8 × 8 at base F = 8), the shares planned per shape
    # so that groups · split stays within two blocks an SM
    plans = [conv_down_dw_plan(*s, False, 1) for s in TRAIN_DOWNS]
    assert all(p.variant == VARIANT_TF32 for p in plans)
    assert [(p.tile_t, p.tile_f, p.tiles, p.groups, p.split) for p in plans] \
        == [(4, 16, 1024, 4, 64), (4, 16, 256, 12, 22), (4, 16, 64, 24, 11),
            (4, 16, 16, 48, 4), (8, 8, 4, 96, 2)]
    assert all(conv_down_dw_plan(*s, True, 1).variant != VARIANT_TF32
               for s in TRAIN_DOWNS)
    # the 3×3 dW at the training stages: split TF32, 128 base positions a
    # tile (8 × 16, 16 × 8 at F = 8), 103 KB (two blocks an SM) with the
    # K sets' scratch inside; the up dW at the up transitions (x's grid): 32
    # base positions (2 × 16, 4 × 8 at F = 8), as 64 would take 142 KB (one
    # block an SM)
    plans = [conv3x3_dw_plan(t, f, c, c, False, 1)
             for t, f, c in TRAIN_STAGES]
    assert all(p.variant == VARIANT_TF32 and p.smem == 103_424
               for p in plans)
    assert [(p.tile_t, p.tile_f, p.tiles, p.groups, p.split) for p in plans] \
        == [(8, 16, 2048, 2, 128), (8, 16, 512, 8, 32), (8, 16, 128, 18, 13),
            (8, 16, 32, 32, 8), (8, 16, 8, 72, 3), (16, 8, 2, 128, 2)]
    plans = [conv_up_dw_plan(*s, False, 1) for s in TRAIN_UPS]
    assert [p.variant for p in plans] == [VARIANT_TF32] * 5
    assert [(p.tile_t, p.tile_f, p.tiles, p.groups, p.split, p.smem)
            for p in plans] == [
        (2, 16, 2048, 4, 64, 75_776), (2, 16, 512, 12, 22, 75_776),
        (2, 16, 128, 24, 11, 75_776), (2, 16, 32, 48, 5, 75_776),
        (4, 8, 8, 96, 2, 72_704)]
    assert all(plan.variant != VARIANT_TF32 for plan in
               [conv3x3_dw_plan(t, f, c, c, True, 1) for t, f, c in
                TRAIN_STAGES] + [conv_up_dw_plan(*s, True, 1)
                                 for s in TRAIN_UPS])


def _tile_origin(plan: TilePlan, tile: int, f_len: int):
    tiles_f = -(-f_len // plan.tile_f)
    return (tile // tiles_f) * plan.tile_t, (tile % tiles_f) * plan.tile_f


def _groups_of(plan: TilePlan, z: int):
    return range(z, plan.groups, plan.split)


def emulate_conv3x3_mma(x, w, *, c, add, residual, pre, pre_silu, post_silu):
    """conv3x3_mma_kernel's grid, block by block, in fp64: the halo of the
    prologue-applied input around each tile (zero outside the array), the
    block's 32·(8 / WN) positions at tile coordinates (p / FT, p % FT), the
    nine taps read at halo offset (dt, df), the block's output-channel groups
    z, z + split, …, stores masked to the array, per-tile partials."""
    b_, t, fc = x.shape
    f = fc // c
    plan = conv3x3_plan(t, f, c, True, b_)
    nb = c // plan.groups
    v = _prologue(x, c, residual, pre, pre_silu, x.dtype).view(b_, t, f, c)
    w64 = w.double()
    out = torch.full((b_, t, f, c), float("nan"), dtype=torch.float64)
    hits = torch.zeros((b_, t, f, c), dtype=torch.int64)
    parts = torch.zeros((b_, plan.tiles, 2, c), dtype=torch.float64)
    tt, ft = plan.tile_t, plan.tile_f
    p = torch.arange(tt * ft)
    pr, pc = p // ft, p % ft
    for b in range(b_):
        for tile in range(plan.tiles):
            t0, f0 = _tile_origin(plan, tile, f)
            halo = torch.zeros((tt + 2, ft + 2, c), dtype=torch.float64)
            ts, fs = slice(max(t0 - 1, 0), min(t0 + tt + 1, t)), \
                slice(max(f0 - 1, 0), min(f0 + ft + 1, f))
            halo[ts.start - t0 + 1:ts.stop - t0 + 1,
                 fs.start - f0 + 1:fs.stop - f0 + 1] = v[b, ts, fs]
            valid = (t0 + pr < t) & (f0 + pc < f)
            for z in range(plan.split):
                for g in _groups_of(plan, z):
                    cos = slice(g * nb, (g + 1) * nb)
                    acc = torch.zeros((tt * ft, nb), dtype=torch.float64)
                    for tap in range(9):
                        dt, df = divmod(tap, 3)
                        acc += halo[pr + dt, pc + df] @ w64[dt, df][:, cos]
                    o = acc + torch.as_tensor(add, dtype=torch.float64)[b, cos]
                    if post_silu:
                        o = torch.nn.functional.silu(o)
                    o = o[valid]
                    out[b, t0 + pr[valid], f0 + pc[valid], cos] = o
                    hits[b, t0 + pr[valid], f0 + pc[valid], cos] += 1
                    parts[b, tile, 0, cos] = o.sum(0)
                    parts[b, tile, 1, cos] = (o * o).sum(0)
    assert torch.all(hits == 1), "every output written by exactly one block"
    tot = parts.sum(dim=1)
    return out.reshape(b_, t, fc), tot[:, 0], tot[:, 1]


def emulate_conv_up_mma(x, w, bias, *, c_in, c_out, residual):
    """conv_up_mma_kernel's grid in fp64: per block the halo of its input
    tile (rows i0 − 1 …, columns j0 − 1 …, zero outside), per parity class
    (py, px) and tap offset (a, b) the halo read at (li + py + a,
    lj + px + b) and the stored tap w[py + 2a, px + 2b], the output at
    (2i + py, 2j + px) + bias + residual, groups of 32 output channels over
    grid.z, per-tile partials of the summed output."""
    b_, t, fc = x.shape
    f = fc // c_in
    plan = conv_up_plan(t, f, c_in, c_out, True, b_)
    xs = x.double().view(b_, t, f, c_in)
    w64 = w.double()
    res = residual.double().view(b_, 2 * t, 2 * f, c_out)
    out = torch.full((b_, 2 * t, 2 * f, c_out), float("nan"),
                     dtype=torch.float64)
    hits = torch.zeros(out.shape, dtype=torch.int64)
    parts = torch.zeros((b_, plan.tiles, 2, c_out), dtype=torch.float64)
    tt, ft = plan.tile_t, plan.tile_f
    p = torch.arange(tt * ft)
    li, lj = p // ft, p % ft
    for b in range(b_):
        for tile in range(plan.tiles):
            i0, j0 = _tile_origin(plan, tile, f)
            halo = torch.zeros((tt + 2, ft + 2, c_in), dtype=torch.float64)
            ts, fs = slice(max(i0 - 1, 0), min(i0 + tt + 1, t)), \
                slice(max(j0 - 1, 0), min(j0 + ft + 1, f))
            halo[ts.start - i0 + 1:ts.stop - i0 + 1,
                 fs.start - j0 + 1:fs.stop - j0 + 1] = xs[b, ts, fs]
            valid = (i0 + li < t) & (j0 + lj < f)
            for z in range(plan.split):
                for g in _groups_of(plan, z):
                    cos = slice(32 * g, 32 * g + 32)
                    s1 = torch.zeros(32, dtype=torch.float64)
                    s2 = torch.zeros(32, dtype=torch.float64)
                    for cls in range(4):
                        py, px = cls >> 1, cls & 1
                        acc = torch.zeros((tt * ft, 32), dtype=torch.float64)
                        for ab in range(4):
                            a, bb = ab >> 1, ab & 1
                            acc += halo[li + py + a, lj + px + bb] @ \
                                w64[py + 2 * a, px + 2 * bb][:, cos]
                        oi = 2 * (i0 + li[valid]) + py
                        oj = 2 * (j0 + lj[valid]) + px
                        o = (acc[valid] + bias.double()[cos]
                             + res[b, oi, oj, cos])
                        out[b, oi, oj, cos] = o
                        hits[b, oi, oj, cos] += 1
                        s1 += o.sum(0)
                        s2 += (o * o).sum(0)
                    parts[b, tile, 0, cos], parts[b, tile, 1, cos] = s1, s2
    assert torch.all(hits == 1), "every output written by exactly one block"
    tot = parts.sum(dim=1)
    return out.reshape(b_, 2 * t, 2 * f * c_out), tot[:, 0], tot[:, 1]


def _close(got, ref, tol):
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        assert err <= tol, err


# (B, T, F, C): F = 8 with C = 256 (s5's geometry), the 16-column tile,
# ragged T and F, and the 256-position block of C = 32 / 96
@pytest.mark.parametrize("b,t,f,c", [(1, 19, 8, 256), (2, 9, 12, 64),
                                     (2, 11, 20, 96), (1, 17, 18, 32),
                                     (2, 5, 3, 192)])
def test_conv3x3_block_model_matches_plain(b, t, f, c):
    rng = np.random.default_rng(t * f + c)

    def r(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s) * scale)
    x, res = r(b, t, f * c), r(b, t, f * c)
    w = r(3, 3, c, c, scale=(9 * c) ** -0.5)
    pre = (1 + 0.1 * r(b, c).float(), 0.1 * r(b, c).float())
    kw = dict(c=c, add=r(b, c), residual=res, pre=pre, pre_silu=True,
              post_silu=True)
    got = emulate_conv3x3_mma(x, w, **kw)
    ref = conv3x3_flat_plain(x, w, want_stats=True, **kw)
    _close(got, ref, 1e-12)


# (B, T_in, F_in, C_in, C_out): f_out = 16 at 256→192, ragged T and F
UP_CASES = [(1, 6, 8, 256, 192), (2, 3, 12, 64, 32), (2, 5, 20, 32, 64),
            (1, 9, 16, 96, 64)]


@pytest.mark.parametrize("b,t,f,c_in,c_out", UP_CASES)
def test_conv_up_subpixel_model_matches_plain(b, t, f, c_in, c_out):
    rng = np.random.default_rng(c_in + f)

    def r(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s) * scale)
    x, w, bias = r(b, t, f * c_in), r(4, 4, c_in, c_out, scale=0.1), r(c_out)
    # the twin adds the residual in fp32 (as the kernel's epilogue does)
    res = r(b, 2 * t, 2 * f * c_out).float().double()
    got = emulate_conv_up_mma(x, w, bias, c_in=c_in, c_out=c_out, residual=res)
    ref = conv_up_flat_plain(x, w, bias, c_in=c_in, c_out=c_out, residual=res,
                             want_stats=True)
    _close(got, ref, 1e-12)


def test_conv_up_subpixel_model_matches_jax_kernel():
    """The sub-pixel form at 256→192, f_out = 16, against the JAX kernel in
    interpret mode (the tolerances of the port's twin test of it)."""
    b, t, f, c_in, c_out = 2, 6, 8, 256, 192
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, t, f * c_in)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c_in, c_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    res = rng.standard_normal((b, 2 * t, 2 * f * c_out)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, r1, r2 = jax_conv_up(
            jnp.asarray(x), pack_up_weights(jnp.asarray(w)), bias,
            c_in=c_in, c_out=c_out, tile_t=2, residual=jnp.asarray(res),
            want_stats=True)
    out, s1, s2 = emulate_conv_up_mma(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        c_in=c_in, c_out=c_out, residual=torch.from_numpy(res))
    fold = [np.asarray(s).reshape(b, -1, c_out).sum(axis=1) for s in (r1, r2)]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), fold[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), fold[1], rtol=1e-5, atol=1e-4)
