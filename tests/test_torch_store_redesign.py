"""The int8-storage conv3x3's tensor-core block, on the CPU.

``csrc/conv3x3_store.cu`` ``conv3x3_store_mma_kernel`` runs only on the
card. What surrounds its arithmetic is checked here:

- its tile plan (``tile_plan.conv3x3_store_plan`` = ``csrc/conv_plan.h``,
  held equal in ``tests/test_torch_conv_redesign.py``): every tensor-core
  tile is a whole number of 8 × 16 storage groups, and
  ``residual_affine_flat`` keeps one statistics partial per storage group;
- a model of the block's walk, against the twin ``conv3x3_flat_plain`` at
  tiny ragged geometries in chip_smoke.py's four modes: per tile the scale
  rows of the storage groups its halo touches staged once (groups outside
  the array are NaN, so a read of one shows), the halo dequantised with
  them in the kernel's order of roundings, the block's output-channel
  groups z, z + split, … (grid.z), the amax of each storage group reduced
  over the block's own positions, the quantisation, one scale per (group,
  channel), per-tile statistics partials, every output and scale written
  once.

The model's taps are the twin's own fp32 ``F.conv2d`` on each tile's
staged halo (both samples at once, as the twin convolves them): on the CPU
oneDNN sums a tile and a channel slice in the same order as the whole
array, so the model's fp32 outputs are the twin's bit for bit and its
integers and scales can be held equal to the twin's. The card's MMA order
is another; chip_smoke.py holds the kernel to its floors there.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddim_audio_tpu_torch.ops.conv_flat import (
    STORE_GROUP,
    conv3x3_flat_plain,
    quantize_store,
)
from ddim_audio_tpu_torch.ops.tile_plan import (
    VARIANT_MMA,
    conv3x3_plan,
    conv3x3_store_plan,
    library_plan,
    residual_affine_plan,
)
from tests.test_torch_conv_redesign import plan_lib  # noqa: F401 (fixture)

torch.set_num_threads(2)

# s0-s3 of [1, 2, 8192, 256] (T, F, C): the stages that store int8
STORE_STAGES = [(8192, 256, 32), (4096, 128, 64), (2048, 64, 96),
                (1024, 32, 128)]
GT, GF = STORE_GROUP


def test_tensor_core_tiles_are_whole_storage_groups():
    """At every storage stage (B = 1, 2, one or two int8 operands) and a
    sweep of ragged and wide shapes, a bf16 tile is 16 columns by a
    multiple of 8 rows, so the tiles cut the array along group borders;
    the storage stages take the tensor cores with 16 × 16 tiles at
    C <= 96 and 8 × 16 at C = 128, where conv3x3_plan's tile is the same;
    at F < 16 the storage tile stays 16 wide where conv3x3's is 32 × 8."""
    shapes = [(t, f, c) for t in (1, 7, 8, 9, 33) for f in (1, 8, 15, 16, 17, 40)
              for c in (32, 64, 96, 128, 192, 256)] + STORE_STAGES
    for t, f, c in shapes:
        for b in (1, 2):
            for scaled in (0, 1, 2):
                p = conv3x3_store_plan(t, f, c, True, b, scaled)
                assert p.variant == VARIANT_MMA, (t, f, c)
                assert p.tile_f == GF and p.tile_t % GT == 0, p
                assert p.tiles == -(-t // p.tile_t) * -(-f // GF)
                assert p.groups % p.split == 0 or p.split == p.groups
    for t, f, c in STORE_STAGES:
        for b in (1, 2):
            p = conv3x3_store_plan(t, f, c, True, b, 1)
            assert (p.tile_t, p.tile_f) == ((16, 16) if c <= 96 else (8, 16))
            assert p[:3] == conv3x3_plan(t, f, c, True, b)[:3]
    assert conv3x3_plan(40, 8, 64, True)[1:3] == (32, 8)
    assert conv3x3_store_plan(40, 8, 64, True)[1:3] == (16, 16)


def test_residual_affine_partials_unchanged(plan_lib):  # noqa: F811
    """residual_affine_flat's statistics partials are one a persistent
    block, which walks whole storage groups (8 × 16 positions × 32
    channels), in the Python model and in the C query its wrapper and
    kernel size them from: never more than the storage groups of a sample,
    whatever the storage conv's tiles are; the storage group stays 8 × 16."""
    for t, f, c in STORE_STAGES + [(1, 1, 32), (9, 17, 64), (19, 40, 128)]:
        groups = -(-t // GT) * -(-f // GF)
        for b in (1, 2):
            plan = residual_affine_plan(t, f, c, 2, 2, b)
            assert plan == library_plan(plan_lib.ddim_residual_affine_plan,
                                        t, f, c, 2, 2, b)
            assert plan[1:3] == (GT, GF) and plan.tiles == plan.grid
            assert 1 <= plan.tiles <= groups
            if t >= 4096:  # s0, s1: far fewer partials than groups
                assert plan.tiles * 4 <= groups
        if t >= 1024:  # the storage conv's tiles: as coarse or coarser
            assert conv3x3_store_plan(t, f, c, True, 1).tiles <= groups
    assert [plan_lib.ddim_store_geometry(i) for i in range(3)] == \
        [GT, GF, -1]


def _tile_origin(plan, tile, f_len):
    tiles_f = -(-f_len // plan.tile_f)
    return (tile // tiles_f) * plan.tile_t, (tile % tiles_f) * plan.tile_f


def emulate_conv3x3_store_mma(x, w, *, c, add, pre, pre_silu, post_silu,
                              want_stats, residual=None, in_scales=None,
                              res_scales=None, quant_out=False):
    """conv3x3_store_mma_kernel's grid, block by block (the batch as a
    tensor dimension): arguments and results as ``conv3x3_flat_plain``."""
    b_, t_len, fc = x.shape
    f_len = fc // c
    x_q, res_q = in_scales is not None, res_scales is not None
    plan = conv3x3_store_plan(t_len, f_len, c, True, b_, int(x_q) + int(res_q))
    assert plan.variant == VARIANT_MMA
    tt, ft, nb = plan.tile_t, plan.tile_f, c // plan.groups
    n_t, n_f = -(-t_len // GT), -(-f_len // GF)
    xs = x.view(b_, t_len, f_len, c)
    rs = None if residual is None else residual.view(b_, t_len, f_len, c)
    sc, sh = pre
    add32 = add.float()
    w32 = w.float().permute(3, 2, 0, 1)  # OIHW of the bf16 weights

    def staged_rows(scales, t0, f0):
        """[B, store_halo_groups, C]: the scale rows of groups
        (t0/8 − 1 + i, f0/16 − 1 + j), NaN outside the array."""
        rows = torch.full((b_, (tt // GT + 2) * 3, c), float("nan"))
        for i in range(tt // GT + 2):
            for j in range(3):
                gr, gc = t0 // GT - 1 + i, f0 // GF - 1 + j
                if 0 <= gr < n_t and 0 <= gc < n_f:
                    rows[:, 3 * i + j] = scales[:, gr, gc]
        return rows

    if quant_out:
        out = torch.zeros((b_, t_len, f_len, c), dtype=torch.int8)
        out_scales = torch.full((b_, n_t, n_f, c), float("nan"))
        scale_hits = torch.zeros((b_, n_t, n_f, c), dtype=torch.int64)
    else:
        out = torch.zeros((b_, t_len, f_len, c), dtype=torch.bfloat16)
    hits = torch.zeros((b_, t_len, f_len, c), dtype=torch.int64)
    parts = torch.zeros((b_, plan.tiles, 2, c), dtype=torch.float64)
    hr, hc = torch.meshgrid(torch.arange(tt + 2), torch.arange(ft + 2),
                            indexing="ij")
    pr, pc = torch.meshgrid(torch.arange(tt), torch.arange(ft), indexing="ij")
    for tile in range(plan.tiles):
        t0, f0 = _tile_origin(plan, tile, f_len)
        # the prologue-applied halo, rounded to bf16, zero outside the array
        th, fh = t0 + hr - 1, f0 + hc - 1
        inside = (th >= 0) & (th < t_len) & (fh >= 0) & (fh < f_len)
        ti, fi = th.clamp(0, t_len - 1), fh.clamp(0, f_len - 1)
        gi = (ti // GT - (t0 // GT - 1)) * 3 + (fi // GF - (f0 // GF - 1))
        v = xs[:, ti, fi]
        if x_q:
            v = v.float() * staged_rows(in_scales, t0, f0)[:, gi]
        if rs is not None:
            r = rs[:, ti, fi]
            if res_q:
                r = r.float() * staged_rows(res_scales, t0, f0)[:, gi]
            v = v.float() + r.float() if x_q or res_q else v + r
        v = v.float() * sc[:, None, None, :] + sh[:, None, None, :]
        if pre_silu:
            v = F.silu(v)
        v = torch.where(inside[None, :, :, None], v, 0.0).to(torch.bfloat16)
        # the taps read the halo rows and columns of the tile's positions
        # inside the array (the rest of a ragged tile's outputs are masked)
        he, we = min(tt, t_len - t0) + 2, min(ft, f_len - f0) + 2
        halo = v[:, :he, :we].float().permute(0, 3, 1, 2).contiguous()
        valid = (t0 + pr < t_len) & (f0 + pc < f_len)
        ot, of = t0 + pr[valid], f0 + pc[valid]
        for z in range(plan.split):
            for g in range(z, plan.groups, plan.split):
                cos = slice(g * nb, (g + 1) * nb)
                o = F.conv2d(halo, w32[cos].contiguous()).permute(0, 2, 3, 1)
                o = o + add32[:, None, None, cos]
                if post_silu:
                    o = F.silu(o)
                ov = o[:, pr[valid], pc[valid]]  # [B, positions, nb]
                parts[:, tile, 0, cos] = ov.double().sum(1)
                parts[:, tile, 1, cos] = (ov.double() ** 2).sum(1)
                hits[:, ot, of, cos] += 1
                if not quant_out:
                    out[:, ot, of, cos] = ov.to(torch.bfloat16)
                    continue
                for i in range(tt // GT):  # the tile's storage group rows
                    rows = valid & (pr // GT == i)
                    if not rows.any():
                        continue
                    og = o[:, pr[rows], pc[rows]]
                    amax = og.abs().amax(dim=1).clamp_min(1e-30)  # [B, nb]
                    inv = torch.full_like(amax, 127.0) / amax
                    q = torch.round(og * inv[:, None]).clamp_(-127, 127)
                    out[:, t0 + pr[rows], f0 + pc[rows], cos] = q.to(torch.int8)
                    grow = t0 // GT + i
                    out_scales[:, grow, f0 // GF, cos] = amax * (1.0 / 127.0)
                    scale_hits[:, grow, f0 // GF, cos] += 1
    assert torch.all(hits == 1), "every output written by exactly one block"
    res_ = (out.reshape(b_, t_len, fc),)
    if quant_out:
        assert torch.all(scale_hits == 1), "every scale written once"
        res_ += (out_scales,)
    if want_stats:
        tot = parts.sum(dim=1).float()
        res_ += (tot[:, 0], tot[:, 1])
    return res_


# chip_smoke.py's four modes: (label, int8 x, kwargs)
MODES = [
    ("float in, quant_out, stats", False, dict(quant_out=True,
                                               want_stats=True)),
    ("int8 in, quant_out, stats", True, dict(quant_out=True, want_stats=True)),
    ("int8 in, quant_out", True, dict(quant_out=True)),
    ("float in, int8 residual, stats", False, dict(residual=True,
                                                   want_stats=True)),
]


# (B, T, F, C): ragged T and F (partial storage groups, a tile row with no
# group in it, F < 16), C = 32 / 64 / 96 (16 × 16 tiles; groups over grid.z)
# and 128 (8 × 16, two warps a position), and a grid wide enough (132 tiles
# at B = 2) that one block walks both groups of C = 64 over its halo
GEOMETRIES = [(2, 19, 20, 32), (2, 9, 36, 64), (1, 13, 8, 96),
              (2, 11, 24, 128), (2, 192, 176, 64)]


@pytest.mark.parametrize("mode", [m[0] for m in MODES])
@pytest.mark.parametrize("b,t,f,c", GEOMETRIES)
def test_store_block_model_matches_plain(b, t, f, c, mode):
    _, x_int8, extra = next(m for m in MODES if m[0] == mode)
    rng = np.random.default_rng(t * f + c)

    def r(*s, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(s) * scale).astype(np.float32))
    x = r(b, t, f, c)
    w = r(3, 3, c, c, scale=(9 * c) ** -0.5).bfloat16()
    kw = dict(c=c, add=r(b, c), pre=(1 + 0.1 * r(b, c), 0.1 * r(b, c)),
              pre_silu=True, post_silu=True,
              want_stats=extra.get("want_stats", False),
              quant_out=extra.get("quant_out", False))
    if x_int8:
        xin, kw["in_scales"] = quantize_store(x)
    else:
        xin = x.reshape(b, t, f * c).bfloat16()
    if extra.get("residual"):
        kw["residual"], kw["res_scales"] = quantize_store(r(b, t, f, c))
    plan = conv3x3_store_plan(t, f, c, True, b, int(x_int8)
                              + int("residual" in kw))
    if (b, t, f, c) == (2, 192, 176, 64):
        assert (plan.tiles, plan.groups, plan.split) == (132, 2, 1)
    got = emulate_conv3x3_store_mma(xin, w, **kw)
    ref = conv3x3_flat_plain(xin, w, **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    if kw["quant_out"]:
        assert got[0].dtype == torch.int8
        assert torch.equal(got[0], ref[0]), \
            (got[0].int() - ref[0].int()).abs().max()
        torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=0)
    else:
        assert torch.equal(got[0], ref[0])
    for a, e in zip(got[-2:] if kw["want_stats"] else (),
                    ref[-2:] if kw["want_stats"] else ()):
        err = (a - e).abs().max() / e.abs().max()
        assert err <= 1e-5, err
