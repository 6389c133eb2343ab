"""Tile plans of the conv3x3, up-conv, down-conv, int8-tap conv3x3, int8-tap
up and down conv, int8-storage conv3x3, head and tail kernels, of the
int8-storage resblock tail (``residual_affine``) and of the three convs'
weight gradients, in Python.

A model of ``csrc/conv_plan.h``: which variant a call takes (0: CUDA cores,
1: tensor cores, 2: tensor cores in split TF32, -1: no kernel takes the
shape), the block's spatial tile,
the spatial tiles per sample (the second dimension of the statistics
partials, which the wrappers size from here), the output-channel groups, how
many blocks share a tile's groups (``split``, grid.z), the dynamic shared
memory and, for a persistent kernel, its blocks along grid.x (``grid``).
``tests/test_torch_conv_redesign.py`` holds the model against the C
functions (``ddim_conv3x3_plan``, ``ddim_conv_up_plan``,
``ddim_conv_down_plan``, ``ddim_conv_up_int8_plan``,
``ddim_conv_down_int8_plan``, ``ddim_conv3x3_dw_plan``,
``ddim_conv_down_dw_plan``, ``ddim_conv_up_dw_plan``,
``ddim_conv3x3_int8_plan``,
``ddim_conv3x3_store_plan``, ``ddim_conv_head_plan``,
``ddim_conv_tail_plan``, ``ddim_residual_affine_plan``) built by the host
compiler; ``chip_smoke.py`` against the kernel library on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

VARIANT_NONE, VARIANT_FMA, VARIANT_MMA, VARIANT_TF32 = -1, 0, 1, 2
MMA_K = 32               # input channels per weight stage
TF32_K = 16              # split TF32: input channels a halo chunk/stage
TF32_PITCH = TF32_K + 4  # floats a halo position (hi and lo planes)
TF32_STAGES = 3          # its weight ring's stages
TF32_MAX_SPLIT = 8       # its K split over a cluster of blocks, at most
UP_TF32_POS = 64         # split-TF32 up: input positions a block and
UP_TF32_OFFS = 2         # tap offsets a stage of its ring
UP_I8_CO = 32            # int8-tap up: output channels a block
DOWN_I8_HALO = 18 * 34   # int8-tap down: input positions of a group
DOWN_I8_MAX_BLOCKS = 2   # its resident blocks an SM, at most
DW_CI = 32               # first dW kernels: input channels a block,
DW_TARGET_BLOCKS = 528   # and the blocks they aim at
DW_TF32_CI = 16          # split-TF32 dW: input channels,
DW_TF32_CO = 32          # output channels a block,
DW_TF32_POS = 64         # base positions a tile aims at (modes 1, 2),
DW3_TF32_POS = 128       # (mode 0),
DW_TF32_BLOCKS = 2       # resident blocks an SM the plan keeps,
DW3_KSETS = 2            # mode 0's warp sets over a tile's k8 steps,
DW_TF32_XP = DW_TF32_CI + 8  # floats a position of its x planes,
DW_TF32_GP = DW_TF32_CO + 8  # of its g planes
CONV_STAGES = 3          # conv3x3 weight ring: stages of a tap row each
UP_STAGES = 3            # up weight ring: stages of one tap per class
DOWN_STAGES = 3          # down weight ring: stages of DOWN_TAPS taps
DOWN_TAPS = 4            # (a tap row)
MMA_RED = 2048           # bytes of the statistics scratch
SMEM_LIMIT = 232_448     # dynamic shared memory a block may ask for
INT8_GROUP = (8, 16)     # int8 taps: a quantisation group's output tile
STORE_GROUP = (8, 16)    # int8 storage: a scale's time rows × columns
FILL_BLOCKS = 2 * 132    # two blocks on each SM of an H100
FMA_POS = 64             # positions per block of the CUDA-core kernels
HEAD_MAX_CIN = 4         # input channels of the head kernels, at most
HEAD_POS = 512           # positions a tensor-core head tile aims at,
HEAD_ROWS = 64           # in at most this many rows
HEAD32_POS = 256         # positions an fp32 head tile aims at
HEAD32_PAD = 4           # floats before position 0 of its halo rows
HEAD_C0 = 32             # output channels of the tensor-core head
HEAD_MU = 2              # m16 tiles a head warp computes at once
HEAD_STAGES = 2          # head: output staging tiles
TAIL_STAGES = 1          # tail: input rows in flight
TAIL_FMA_TILE = (8, 16)  # the CUDA-core tail block's output tile
SMS = 132                # an H100's SMs
SMEM_PER_SM = 233_472    # shared memory of an SM
RES_STAGES = 3           # residual_affine: units staged or in flight a
                         # block,
RES_BLOCKS = 4           # resident blocks an SM, at most,
RES_RED = 1024           # bytes of its amax and statistics scratch


class TilePlan(NamedTuple):
    variant: int
    tile_t: int
    tile_f: int
    tiles: int
    groups: int
    split: int
    smem: int
    grid: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fma_tile(f_out: int) -> tuple[int, int]:
    ft = 16 if f_out >= 16 else 8
    return FMA_POS // ft, ft


def _fma_plan(t_out: int, f_out: int, c_out: int) -> TilePlan:
    tt, ft = _fma_tile(f_out)
    groups = _cdiv(c_out, 32)
    return TilePlan(VARIANT_FMA, tt, ft, _cdiv(t_out, tt) * _cdiv(f_out, ft),
                    groups, groups, 0)


def fill_split(tiles: int, batch: int, groups: int) -> int:
    """Blocks that share a tile's output-channel groups: only as many as the
    spatial grid needs to reach FILL_BLOCKS, dividing the groups evenly."""
    have = tiles * batch
    split = 1 if have >= FILL_BLOCKS else _cdiv(FILL_BLOCKS, have)
    while split < groups and groups % split:
        split += 1
    return min(split, groups)


def tf32_ksplit(blocks: int, c_in: int) -> int:
    """The K split of a split-TF32 kernel: a cluster of blocks where a
    sample's grid of ``blocks`` stays under one block an SM, two TF32_K
    chunks of the input channels a block at least, TF32_MAX_SPLIT at most."""
    ksplit = 1 if blocks >= SMS else SMS // blocks
    return max(1, min(ksplit, c_in // TF32_K // 2, TF32_MAX_SPLIT))


def _conv3x3_tf32_smem(tt: int, ft: int, nb: int) -> int:
    hn = (tt + 2) * (ft + 2)
    return 4 * (2 * hn * TF32_K + 2 * hn * TF32_PITCH
                + TF32_STAGES * 3 * TF32_K * (nb + 8)) + MMA_RED


def conv3x3_plan(t: int, f: int, c: int, bf16: bool,
                 batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv3x3`` at [batch, t, f, c]. fp32 at C % 32 == 0
    runs split TF32: two warps across 64 output channels where C % 64 == 0,
    else one across 32; 128 positions a block at WN = 2 (MT = 2) where two
    such blocks fit an SM's shared memory and one sample's grid of them
    reaches FILL_BLOCKS, else half as many (MT = 1); one output-channel
    group a block and the K split over a cluster (``split`` = ``groups`` ·
    the K split)."""
    if not bf16 and c % 32 == 0:
        nb = 64 if c % 64 == 0 else 32
        ft = 16 if f >= 16 else 8
        tt = 16 * 2 * (8 // (nb // 32)) // ft
        groups = c // nb
        if (2 * (_conv3x3_tf32_smem(tt, ft, nb) + 1024) > SMEM_PER_SM
                or _cdiv(t, tt) * _cdiv(f, ft) * groups < FILL_BLOCKS):
            tt //= 2  # MT = 1
        tiles = _cdiv(t, tt) * _cdiv(f, ft)
        return TilePlan(VARIANT_TF32, tt, ft, tiles, groups,
                        groups * tf32_ksplit(tiles * groups, c),
                        _conv3x3_tf32_smem(tt, ft, nb))
    if bf16 and c % 32 == 0:
        wn = 2 if c >= 128 and c % 64 == 0 else 1  # warps across a group
        m, nb = 32 * (8 // wn), 32 * wn
        ft = 16 if f >= 16 else 8
        tt = m // ft
        tiles = _cdiv(t, tt) * _cdiv(f, ft)
        groups = c // nb
        smem = 2 * ((tt + 2) * (ft + 2) * (c + 8)
                    + CONV_STAGES * 3 * MMA_K * (nb + 8)) + MMA_RED
        if smem <= SMEM_LIMIT:
            return TilePlan(VARIANT_MMA, tt, ft, tiles, groups,
                            fill_split(tiles, batch, groups), smem)
    return _fma_plan(t, f, c)


def conv_up_plan(t_in: int, f_in: int, c_in: int, c_out: int, bf16: bool,
                 batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv_up`` for an input [batch, t_in, f_in, c_in];
    the tensor-core tile is in input positions (128 a block in bf16; in
    split TF32, fp32, UP_TF32_POS, one group of 32 output channels a block
    and the K split over a cluster: ``split`` = ``groups`` · the K split)."""
    if not bf16 and c_in % 32 == 0 and c_out % 32 == 0:
        ft = 16 if f_in >= 16 else 8
        tt = UP_TF32_POS // ft
        tiles = _cdiv(t_in, tt) * _cdiv(f_in, ft)
        groups = c_out // 32
        hn = (tt + 2) * (ft + 2)
        smem = 4 * (hn * TF32_K + 2 * hn * TF32_PITCH
                    + TF32_STAGES * UP_TF32_OFFS * 4 * TF32_K * (32 + 8)) \
            + MMA_RED
        return TilePlan(VARIANT_TF32, tt, ft, tiles, groups,
                        groups * tf32_ksplit(tiles * groups, c_in), smem)
    if bf16 and c_in % 32 == 0 and c_out % 32 == 0:
        ft = 16 if f_in >= 16 else 8
        tt = 128 // ft
        tiles = _cdiv(t_in, tt) * _cdiv(f_in, ft)
        groups = c_out // 32
        smem = 2 * ((tt + 2) * (ft + 2) * (c_in + 8)
                    + UP_STAGES * 4 * MMA_K * (32 + 8)) + MMA_RED
        if smem <= SMEM_LIMIT:
            return TilePlan(VARIANT_MMA, tt, ft, tiles, groups,
                            fill_split(tiles, batch, groups), smem)
    return _fma_plan(2 * t_in, 2 * f_in, c_out)


def _down_smem(tt: int, ft: int, c_in: int, nb: int) -> int:
    return 2 * ((2 * tt + 2) * (2 * ft + 2) * (c_in + 8)
                + DOWN_STAGES * DOWN_TAPS * MMA_K * (nb + 8)) + MMA_RED


def _down_tf32_smem(tt: int, ft: int, nb: int) -> int:
    return 4 * (2 * (2 * tt + 2) * (2 * ft + 2) * TF32_PITCH
                + TF32_STAGES * DOWN_TAPS * TF32_K * (nb + 8)) + MMA_RED


def conv_down_plan(t_in: int, f_in: int, c_in: int, c_out: int, bf16: bool,
                   batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv_down`` for an input [batch, t_in, f_in, c_in]
    (tile in output positions). bf16: 128 or 256 positions a block where
    their halo fits, else half as many. fp32 (split TF32): the same warps,
    one output-channel group a block (``split`` = ``groups``), 128 or 256
    positions where one sample's grid reaches FILL_BLOCKS, else half as
    many; where that grid stays under SMS blocks, the input channels split
    over a cluster of blocks (``split`` = ``groups`` · the K split)."""
    t_out, f_out = t_in // 2, f_in // 2
    if not bf16 and c_in % 32 == 0 and c_out % 32 == 0:
        nb = 64 if c_out % 64 == 0 else 32
        ft = 16 if f_out >= 16 else 8
        tt = 16 * 2 * (8 // (nb // 32)) // ft
        groups = c_out // nb
        if _cdiv(t_out, tt) * _cdiv(f_out, ft) * groups < FILL_BLOCKS:
            tt //= 2  # MT = 1: one sample's grid decides
        tiles = _cdiv(t_out, tt) * _cdiv(f_out, ft)
        return TilePlan(VARIANT_TF32, tt, ft, tiles, groups,
                        groups * tf32_ksplit(tiles * groups, c_in),
                        _down_tf32_smem(tt, ft, nb))
    if bf16 and c_in % MMA_K == 0 and c_out % 32 == 0:
        nb = 64 if c_out % 64 == 0 else 32  # 32 output channels a warp
        ft = 16 if f_out >= 16 else 8
        tt = 16 * 2 * (8 // (nb // 32)) // ft
        smem = _down_smem(tt, ft, c_in, nb)
        if smem > SMEM_LIMIT:
            tt //= 2
            smem = _down_smem(tt, ft, c_in, nb)
        if smem <= SMEM_LIMIT:
            tiles = _cdiv(t_out, tt) * _cdiv(f_out, ft)
            groups = c_out // nb
            return TilePlan(VARIANT_MMA, tt, ft, tiles, groups,
                            fill_split(tiles, batch, groups), smem)
    return _fma_plan(t_out, f_out, c_out)


def conv3x3_int8_plan(t: int, f: int, c: int, bf16: bool,
                      batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv3x3_int8`` at [batch, t, f, c]: one
    quantisation group (an 8 × 16 output tile) a tile, all C output channels
    in one group; the grid is persistent (as many blocks as stay resident),
    so ``split`` is 1 and the batch does not enter."""
    del batch, bf16  # fp32: raw x; bf16: raw x and residual, as many bytes
    q_t, q_f = INT8_GROUP
    tiles = _cdiv(t, q_t) * _cdiv(f, q_f)
    if c not in (32, 64, 96):
        return TilePlan(VARIANT_NONE, q_t, q_f, tiles, 1, 1, 0)
    pitch = c + 16
    wm = (384 if c == 96 else 256) // 32 // (c // 32)  # warps over positions
    halo = (q_t + 2) * (q_f + 2)
    smem = (9 * c * pitch + halo * pitch + halo * c * 4 + 4 * wm * 2 * c
            + 4 * 16)
    return TilePlan(VARIANT_MMA, q_t, q_f, tiles, 1, 1, smem)


def conv_up_int8_plan(t_in: int, f_in: int, c_in: int, c_out: int,
                      bf16: bool, batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv_up_int8`` for an input [batch, t_in, f_in,
    c_in]: one quantisation group (an 8 × 16 output tile) a tile and a
    statistics partial, UP_I8_CO output channels a block (``split`` =
    ``groups`` on grid.z); grid.x is persistent (as many blocks as stay
    resident), so the batch does not enter."""
    del batch
    q_t, q_f = INT8_GROUP
    tiles = _cdiv(2 * t_in, q_t) * _cdiv(2 * f_in, q_f)
    groups = _cdiv(c_out, UP_I8_CO)
    pitch, halo = c_in + 16, (q_t // 2 + 2) * (q_f // 2 + 2)
    smem = (16 * UP_I8_CO * pitch + _cdiv(halo * pitch, 16) * 16
            + halo * c_in * (2 if bf16 else 4) + 4 * (8 * 2 * UP_I8_CO + 8))
    ok = (0 < c_in <= 256 and c_in % 32 == 0 and c_out > 0
          and c_out % UP_I8_CO == 0 and smem <= SMEM_LIMIT)
    return TilePlan(VARIANT_MMA if ok else VARIANT_NONE, q_t, q_f, tiles,
                    groups, groups, smem if ok else 0)


def conv_down_int8_smem(c_in: int, co: int, bf16: bool) -> int:
    """The int8-tap down conv's shared memory: the 16 taps' weights, the
    int8 halo, the raw halo in x's dtype, the statistics and amax scratch."""
    return (16 * co * c_in + DOWN_I8_HALO * c_in
            + DOWN_I8_HALO * c_in * (2 if bf16 else 4) + 4 * (8 * 2 * co + 8))


def down_int8_resident(smem: int) -> int:
    """Resident blocks an SM of the int8-tap down conv: as many as the
    shared memory leaves room for, 1 … DOWN_I8_MAX_BLOCKS."""
    return max(1, min(DOWN_I8_MAX_BLOCKS, SMEM_PER_SM // (smem + 1024)))


def conv_down_int8_plan(t_in: int, f_in: int, c_in: int, c_out: int,
                        bf16: bool, batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv_down_int8`` for an input [batch, t_in, f_in,
    c_in]: one quantisation group (an 8 × 16 output tile) a tile and a
    statistics partial, 64 output channels a block where C_out allows and
    the shared memory fits, else 32 (``split`` = ``groups`` on grid.z). At
    C_in 32 or 64 the persistent kernel: ``grid`` = its blocks along grid.x
    (the resident blocks of every SM shared by the groups, at most one a
    group); at C_in 96 … 256 the two-pass kernel (``grid`` 0: a block a
    group)."""
    q_t, q_f = INT8_GROUP
    tiles = _cdiv(t_in // 2, q_t) * _cdiv(f_in // 2, q_f)
    co = 64 if c_out % 64 == 0 else 32
    if conv_down_int8_smem(c_in, co, bf16) > SMEM_LIMIT:
        co = 32
    groups = _cdiv(c_out, co) if c_out > 0 else 0
    smem = conv_down_int8_smem(c_in, co, bf16)
    if not (0 < c_in <= 256 and c_in % 32 == 0 and c_out > 0
            and c_out % 32 == 0):
        return TilePlan(VARIANT_NONE, q_t, q_f, tiles, groups, groups, 0)
    if c_in not in (32, 64) or smem > SMEM_LIMIT:  # the two-pass kernel
        co = 64 if c_out % 64 == 0 else 32
        smem = (_cdiv(DOWN_I8_HALO * (c_in + 16), 16) * 16
                + max(16 * co * (32 + 16), 128 * (co + 8) * 4))
        return TilePlan(VARIANT_MMA, q_t, q_f, tiles, c_out // co,
                        c_out // co, smem)
    per_z = max(1, down_int8_resident(smem) * SMS // groups)
    return TilePlan(VARIANT_MMA, q_t, q_f, tiles, groups, groups, smem,
                    min(batch * tiles, per_z))


def _dw_first_plan(tb: int, fb: int, np_: int, ttm: int, c_in: int,
                   c_out: int, bf16: bool, batch: int) -> TilePlan:
    """The first weight-gradient kernels' plan (CUDA cores, or bf16 WMMA):
    base grid tb × fb, np_ base positions a CUDA-core tile, ttm rows of 16 a
    WMMA tile; ``tiles`` the batch's, ``split`` the position shares."""
    mma = bf16 and fb >= 16 and c_in % 32 == 0 and c_out % 32 == 0
    ft = 16 if mma else (16 if fb >= 16 else 8)
    tt = ttm if mma else np_ // ft
    tiles = batch * _cdiv(tb, tt) * _cdiv(fb, ft)
    groups = _cdiv(c_in, DW_CI) * _cdiv(c_out, 32)
    per = max(1, _cdiv(tiles, _cdiv(DW_TARGET_BLOCKS, groups)))
    return TilePlan(VARIANT_MMA if mma else VARIANT_FMA, tt, ft, tiles,
                    groups, _cdiv(tiles, per), 0)


def dw_tf32_threads(mode: int) -> int:
    """Threads a block of the split-TF32 dW kernel: three warps a K set in
    mode 0 (a warp a tap row), eight in modes 1 and 2 (a warp two taps)."""
    return 96 * DW3_KSETS if mode == 0 else 256


def dw_tf32_smem(mode: int, tt: int, ft: int) -> int:
    """The split-TF32 dW's shared memory for a tt × ft base tile: the raw x
    halo (stride 1 in modes 0 and 2, 2 in mode 1) and g tile (2tt × 2ft in
    mode 2) and their hi and lo planes; in mode 0 at least the scratch in
    which the K sets but the first leave their totals."""
    hx = ((2 * tt + 2) * (2 * ft + 2) if mode == 1
          else (tt + 2) * (ft + 2))
    hg = 4 * tt * ft if mode == 2 else tt * ft
    stage = 4 * (hx * (DW_TF32_CI + 2 * DW_TF32_XP)
                 + hg * (DW_TF32_CO + 2 * DW_TF32_GP))
    reduce = (4 * (DW3_KSETS - 1) * 9 * DW_TF32_CI * DW_TF32_CO
              if mode == 0 else 0)
    return max(stage, reduce)


def _dw_tf32_plan(mode: int, tb: int, fb: int, c_in: int, c_out: int,
                  batch: int) -> TilePlan:
    """Split TF32 over the base grid tb × fb: a block all the taps ×
    DW_TF32_CI × DW_TF32_CO channels (``groups`` such blocks), tiles of
    DW3_TF32_POS (mode 0) or DW_TF32_POS base positions 16 or 8 wide, rows
    halved until DW_TF32_BLOCKS blocks fit an SM, ``split`` shares of the
    batch's ``tiles`` so that groups · split stays within FILL_BLOCKS."""
    ft = 16 if fb >= 16 else 8
    tt = (DW3_TF32_POS if mode == 0 else DW_TF32_POS) // ft
    while (tt > 1 and DW_TF32_BLOCKS * (dw_tf32_smem(mode, tt, ft) + 1024)
           > SMEM_PER_SM):
        tt //= 2
    tiles = batch * _cdiv(tb, tt) * _cdiv(fb, ft)
    groups = (c_in // DW_TF32_CI) * (c_out // DW_TF32_CO)
    per = max(1, _cdiv(tiles, max(1, FILL_BLOCKS // groups)))
    return TilePlan(VARIANT_TF32, tt, ft, tiles, groups, _cdiv(tiles, per),
                    dw_tf32_smem(mode, tt, ft))


def _dw_first_tile(mode: int) -> tuple[int, int]:
    """The first kernels' base positions a CUDA-core tile and rows of 16 a
    WMMA tile."""
    return (64, 8) if mode == 0 else (32, 4)


def _dw_tf32_takes(c_in: int, c_out: int, bf16: bool) -> bool:
    return (not bf16 and c_in > 0 and c_out > 0 and c_in % DW_TF32_CI == 0
            and c_out % DW_TF32_CO == 0)


def conv3x3_dw_plan(t: int, f: int, c_in: int, c_out: int, bf16: bool,
                    batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv_dw`` in mode 0 (the 3×3 conv's weight
    gradient) for x [batch, t, f, c_in]: fp32 at C_in % 16 == C_out % 32 ==
    0 runs split TF32 (``_dw_tf32_plan``, base grid T × F); else the first
    kernels. ``split`` is the partials' first dimension."""
    if not _dw_tf32_takes(c_in, c_out, bf16):
        return _dw_first_plan(t, f, *_dw_first_tile(0), c_in, c_out, bf16,
                              batch)
    return _dw_tf32_plan(0, t, f, c_in, c_out, batch)


def conv_down_dw_plan(t_in: int, f_in: int, c_in: int, c_out: int,
                      bf16: bool, batch: int = 1) -> TilePlan:
    """The same in mode 1 (the down conv's weight gradient; base grid g's
    T/2 × F/2)."""
    tb, fb = t_in // 2, f_in // 2
    if not _dw_tf32_takes(c_in, c_out, bf16):
        return _dw_first_plan(tb, fb, *_dw_first_tile(1), c_in, c_out,
                              bf16, batch)
    return _dw_tf32_plan(1, tb, fb, c_in, c_out, batch)


def conv_up_dw_plan(t_in: int, f_in: int, c_in: int, c_out: int,
                    bf16: bool, batch: int = 1) -> TilePlan:
    """The same in mode 2 (the up conv's weight gradient; base grid x's
    T × F, g at 2T × 2F)."""
    if not _dw_tf32_takes(c_in, c_out, bf16):
        return _dw_first_plan(t_in, f_in, *_dw_first_tile(2), c_in, c_out,
                              bf16, batch)
    return _dw_tf32_plan(2, t_in, f_in, c_in, c_out, batch)


def store_tiles(t: int, f: int) -> int:
    """Storage groups per sample: ceil(T/8) · ceil(F/16)."""
    return _cdiv(t, STORE_GROUP[0]) * _cdiv(f, STORE_GROUP[1])


def res_kind_bytes(kind: int) -> int:
    """Bytes of a value of operand kind 0 (fp32), 1 (bf16) or 2 (int8)."""
    return (4, 2, 1)[kind]


def residual_affine_plan(t: int, f: int, c: int, x_kind: int, s_kind: int,
                         batch: int = 1) -> TilePlan:
    """The plan of ``ddim_residual_affine`` at [batch, t, f, c] with x and s
    of kinds ``x_kind`` and ``s_kind`` (0 fp32, 1 bf16, 2 int8): persistent
    blocks of 128 threads, one sample (grid.y) and one group of 32
    channels (grid.z) a block, walking the sample's storage groups ("units"
    of 8 × 16 positions × 32 channels) ``grid`` apart with RES_STAGES units
    staged or in flight; ``grid`` as many blocks as stay resident (at most
    RES_BLOCKS an SM) spread over batch and groups, and ``tiles`` = ``grid``
    statistics partials a sample, one a block. Variant 0 (CUDA cores) at
    C % 32 == 0, else none."""
    q_t, q_f = STORE_GROUP
    stage = q_t * q_f * 32 * (res_kind_bytes(x_kind)
                              + res_kind_bytes(s_kind)) + 2 * 32 * 4
    smem = RES_STAGES * stage + RES_RED
    per_sm = min(SMEM_PER_SM // (smem + 1024), RES_BLOCKS)
    groups = _cdiv(c, 32)
    grid = min(store_tiles(t, f), _cdiv(per_sm * SMS, batch * groups))
    variant = VARIANT_FMA if c > 0 and c % 32 == 0 else VARIANT_NONE
    return TilePlan(variant, q_t, q_f, grid, groups, groups, smem, grid)


def conv3x3_store_plan(t: int, f: int, c: int, bf16: bool, batch: int = 1,
                       scaled: int = 1) -> TilePlan:
    """The plan of ``ddim_conv3x3_store`` at [batch, t, f, c] with
    ``scaled`` int8 operands (x, residual: 0-2), whose halo scale rows the
    block stages. bf16: conv3x3's tensor-core block with a tile always 16
    columns wide (16 × 16 at C <= 96, 8 × 16 from C = 128 on), so that each
    tile is a union of whole storage groups; fp32: the CUDA-core kernel, one
    storage group × 32 channels a block."""
    q_t, q_f = STORE_GROUP
    if not bf16:
        groups = _cdiv(c, 32)
        return TilePlan(VARIANT_FMA if c % 32 == 0 else VARIANT_NONE, q_t,
                        q_f, store_tiles(t, f), groups, groups, 0)
    wn = 2 if c >= 128 and c % 64 == 0 else 1  # as conv3x3_plan
    nb = 32 * wn
    tt = 32 * (8 // wn) // q_f
    tiles = _cdiv(t, tt) * _cdiv(f, q_f)
    groups = c // nb
    split = fill_split(tiles, batch, groups)
    halo_groups = (tt // q_t + 2) * 3
    smem = (2 * ((tt + 2) * (q_f + 2) * (c + 8)
                 + CONV_STAGES * 3 * MMA_K * (nb + 8)) + MMA_RED
            + 4 * scaled * halo_groups * c)
    if c % 32 or smem > SMEM_LIMIT:
        return TilePlan(VARIANT_NONE, tt, q_f, tiles, groups, split, 0)
    return TilePlan(VARIANT_MMA, tt, q_f, tiles, groups, split, smem)


def head_halo_pitch(f: int, c_in: int) -> int:
    """Elements of a head halo row (16 words mod 32, 8 elements of pad)."""
    return _cdiv(f * c_in + 16, 64) * 64 + 32


def head32_halo_pitch(f: int, c_in: int) -> int:
    """Floats of an fp32 head halo row (20 words mod 32, HEAD32_PAD floats
    of pad)."""
    return _cdiv(HEAD32_PAD + (f + 1) * c_in, 32) * 32 + 20


def conv_head_plan(t: int, f: int, c_in: int, c0: int, bf16: bool,
                   batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv_head`` at [batch, t, f, c_in] → c0. At
    C0 = 32 the persistent tensor-core kernels, tiles of ``tile_t`` whole
    rows (bf16: HEAD_POS positions, fp32: HEAD32_POS; at least one row and
    at most HEAD_ROWS),
    ``tiles`` = blocks a sample = statistics partials a sample (one a
    block); bf16 on mma.sync bf16 and no kernel where its rows do not fit
    in shared memory, fp32 in split TF32 and the CUDA-core kernel where
    they do not fit; else the CUDA-core kernel, one partial a 64-position
    tile."""
    cin_ok = 1 <= c_in <= HEAD_MAX_CIN
    if cin_ok and not bf16 and c0 == HEAD_C0:
        tt = 1 if f >= HEAD32_POS else min(HEAD32_POS // f, HEAD_ROWS)
        smem = 4 * (tt + 2) * head32_halo_pitch(f, c_in) * 4 + MMA_RED
        if smem <= SMEM_LIMIT:
            blocks = min(_cdiv(t, tt), _cdiv(FILL_BLOCKS, batch))
            return TilePlan(VARIANT_TF32, tt, f, blocks, 1, 1, smem)
    if cin_ok and bf16 and c0 == HEAD_C0:
        tt = 1 if f >= HEAD_POS else min(HEAD_POS // f, HEAD_ROWS)
        m = _cdiv(tt * f, 16 * HEAD_MU) * 16 * HEAD_MU
        smem = (HEAD_STAGES * m * c0 * 2
                + 2 * (tt + 2) * head_halo_pitch(f, c_in) * 2 + MMA_RED)
        blocks = min(_cdiv(t, tt), _cdiv(FILL_BLOCKS, batch))
        return TilePlan(VARIANT_MMA if smem <= SMEM_LIMIT else VARIANT_NONE,
                        tt, f, blocks, 1, 1, smem)
    plan = _fma_plan(t, f, c0)
    return plan if cin_ok else plan._replace(variant=VARIANT_NONE)


def tail_smem(f: int, c0: int, c_out: int) -> int:
    """Shared memory of the tensor-core tail: three v rows, TAIL_STAGES raw
    h and residual rows, the partials P and the weights."""
    fp, np_ = _cdiv(f, 16) * 16, 8 * _cdiv(3 * c_out, 8)
    return (2 * 3 * fp * (c0 + 8) + 2 * TAIL_STAGES * 2 * f * c0
            + 4 * np_ * (fp + 4) + 2 * np_ * (3 * c0 + 8))


def conv_tail_plan(t: int, f: int, c0: int, c_out: int, bf16: bool,
                   batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv_tail`` at [batch, t, f, c0] → c_out. bf16:
    the tensor-core kernel, a block a band of ``tile_t`` whole rows,
    ``tiles`` bands a sample (as many blocks as stay resident on the card,
    spread over the batch), no kernel where a row does not fit in shared
    memory; fp32: the CUDA-core kernel on 8 × 16 tiles."""
    ok = c0 > 0 and c0 % 32 == 0 and c_out in (1, 2, 4)
    if ok and bf16:
        smem = tail_smem(f, c0, c_out)
        per_sm = 2 if 2 * (smem + 1024) <= SMEM_PER_SM else 1
        band = _cdiv(t, _cdiv(SMS * per_sm, batch))
        return TilePlan(VARIANT_MMA if smem <= SMEM_LIMIT else VARIANT_NONE,
                        band, f, _cdiv(t, band), 1, 1, smem)
    tt, ft = TAIL_FMA_TILE
    return TilePlan(VARIANT_FMA if ok else VARIANT_NONE, tt, ft,
                    _cdiv(t, tt) * _cdiv(f, ft), 1, 1, 0)


def library_plan(fn, *args) -> TilePlan:
    """A plan as the C query ``fn`` (``ddim_<kernel>_plan`` of a loaded
    library) reports it."""
    out = (ctypes.c_int * len(TilePlan._fields))()
    fn(*args, ctypes.cast(out, ctypes.c_void_p))
    return TilePlan(*out)
