"""Tile plans of the conv3x3, up-conv, down-conv, int8-tap conv3x3, int8-tap
up-conv, int8-storage conv3x3, head and tail kernels, in Python.

A model of ``csrc/conv_plan.h``: which variant a call takes (0: CUDA cores,
1: tensor cores, 2: tensor cores in split TF32, -1: no kernel takes the
shape), the block's spatial tile,
the spatial tiles per sample (the second dimension of the statistics
partials, which the wrappers size from here), the output-channel groups, how
many blocks share a tile's groups (``split``, grid.z) and the dynamic shared
memory. ``tests/test_torch_conv_redesign.py`` holds the model against the C
functions (``ddim_conv3x3_plan``, ``ddim_conv_up_plan``,
``ddim_conv_down_plan``, ``ddim_conv_up_int8_plan``,
``ddim_conv3x3_int8_plan``,
``ddim_conv3x3_store_plan``, ``ddim_conv_head_plan``,
``ddim_conv_tail_plan``, ``ddim_residual_affine_tiles``) built by the host
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
HEAD_C0 = 32             # output channels of the tensor-core head
HEAD_MU = 2              # m16 tiles a head warp computes at once
HEAD_STAGES = 2          # head: output staging tiles
TAIL_STAGES = 1          # tail: input rows in flight
TAIL_FMA_TILE = (8, 16)  # the CUDA-core tail block's output tile
SMS = 132                # an H100's SMs
SMEM_PER_SM = 233_472    # shared memory of an SM


class TilePlan(NamedTuple):
    variant: int
    tile_t: int
    tile_f: int
    tiles: int
    groups: int
    split: int
    smem: int


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


def store_tiles(t: int, f: int) -> int:
    """Storage groups per sample: ceil(T/8) · ceil(F/16)."""
    return _cdiv(t, STORE_GROUP[0]) * _cdiv(f, STORE_GROUP[1])


def residual_affine_tiles(t: int, f: int) -> int:
    """Statistics partials per sample of ``ddim_residual_affine``: one a
    storage group (its block is a group × 32 channels)."""
    return store_tiles(t, f)


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


def conv_head_plan(t: int, f: int, c_in: int, c0: int, bf16: bool,
                   batch: int = 1) -> TilePlan:
    """The plan of ``ddim_conv_head`` at [batch, t, f, c_in] → c0. bf16 at
    C0 = 32: the persistent tensor-core kernel, tiles of ``tile_t`` whole
    rows (HEAD_POS positions, at least one row and at most HEAD_ROWS),
    ``tiles`` = blocks a sample = statistics partials a sample (one a
    block), no kernel where its rows do not fit in shared memory; else the
    CUDA-core kernel, one partial a 64-position tile."""
    cin_ok = 1 <= c_in <= HEAD_MAX_CIN
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
