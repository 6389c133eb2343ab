"""The persistent int8-tap down conv and the split-TF32 down-conv weight
gradient, on the CPU.

The CUDA kernels (``csrc/conv_strided_int8.cu`` ``conv_down_int8_kernel``,
``csrc/conv_dw.cu`` ``conv_dw_tf32_kernel``) run only on the card. What
surrounds their arithmetic is checked here (their tile plans against
``csrc/conv_plan.cu``: tests/test_torch_conv_redesign.py):

- a model of the int8 down kernel's persistent walk (blocks over
  quantisation groups for each output-channel group, the one raw buffer
  holding the group being computed and then the next one, prefetched after
  the requant, the
  amax and requant of the 18 × 34 input positions, the int8 halo and the
  weights in planes of 16 channels, each halo row's even columns before its
  odd ones, the taps read from the [4, 4, C_out, C_in] weights, one
  statistics partial a group at the group's index) bit-equal to
  ``conv_down_flat_int8_plain`` at ragged edges, F = 8, B = 1-3 and several
  grid caps;
- a model of the weight gradient's blocks (all 16 taps × 16 input × 32
  output channels a block, contiguous shares of the position tiles, each
  tile's x halo and g tile split once into TF32 hi and lo planes, the taps'
  rows read through the planes' slots, each tile's sum folded into the
  block's total, the shares' partials summed in order): in fp64 against the
  plain twin, and with the split-TF32 products against the JAX package's
  ``conv_down_dw_flat`` in Pallas interpret mode, where single-pass TF32 is
  shown to fall short;
- the [4, 4, C_out, C_in] int8 weights that ``prepare_params`` makes for the
  int8 down transition, and the twin fed from the prepared tree unchanged.

The module imports no JAX at top level (the JAX test imports it inside), so
its ``gpu`` tests run on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_downi8_dw_redesign.py -m
gpu``.
"""

import numpy as np
import pytest
import torch

from ddim_audio_tpu_torch.config import dict2namespace
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.ops.conv_flat import int8_weights_co_ci
from ddim_audio_tpu_torch.ops.conv_strided import (
    conv_down_flat,
    conv_down_flat_int8,
    conv_down_flat_int8_plain,
    quantize_strided_weights_int8,
)
from ddim_audio_tpu_torch.ops.flat_grad import (
    conv_down_dw_flat,
    conv_down_dw_flat_plain,
)
from ddim_audio_tpu_torch.ops.flat_resblock import conv3x3_taps
from ddim_audio_tpu_torch.ops.tile_plan import (
    DW_TF32_CI,
    DW_TF32_CO,
    VARIANT_MMA,
    VARIANT_TF32,
    conv_down_dw_plan,
    conv_down_int8_plan,
    library_plan,
)

torch.set_num_threads(2)


def _cdiv(a, b):
    return -(-a // b)


def _close(got, ref, tol):
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        assert err <= tol, err


def _slots(rows, cols):
    """Slot of halo position (r, c) in a plane whose rows hold their even
    columns, then their odd ones (the stride-2 operand's layout)."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    return (r * cols + (c % 2) * (cols // 2) + c // 2).reshape(-1)


# ------------------------------------------------ int8-tap down, persistent --

def emulate_conv_down_int8(x, wq, w_scale, bias, *, c_in, c_out, grid_cap):
    """conv_down_int8_kernel's walk: for each output-channel group z (CO
    channels, grid.z), block i of min(plan grid, ``grid_cap``) takes
    quantisation groups i, i + grid, …; one raw buffer holds the group
    being computed (staged before the walk, then by the prefetch issued
    after the requant); the amax and requant are the twin's (the 18 × 34
    input positions of the group, zero outside); the int8 halo
    [plane][slot][16]
    with slot = r·34 + (c & 1)·17 + c / 2, the weights [tap][plane][co][16]
    from the [4, 4, C_out, C_in] copy; warp w owns output row w of the tile,
    its A rows the 16 slots of its columns for each tap; the epilogue the
    twin's fp32 operations in the twin's order: float(acc) · (s_q ·
    w_scale) + bias; one statistics partial a group, at (b, tile)."""
    b_, t_in, fc = x.shape
    f_in = fc // c_in
    t_out, f_out = t_in // 2, f_in // 2
    plan = conv_down_int8_plan(t_in, f_in, c_in, c_out,
                               x.dtype == torch.bfloat16, b_)
    assert plan.variant == VARIANT_MMA and plan.split == plan.groups
    assert plan.grid == min(b_ * plan.tiles, plan.grid)
    grid = min(plan.grid, grid_cap)
    co_n = c_out // plan.groups
    planes = c_in // 16
    tiles_f = _cdiv(f_out, 16)
    xs = x.float().view(b_, t_in, f_in, c_in)
    wt = int8_weights_co_ci(wq)  # [4, 4, co, ci], as the kernel reads it
    out = torch.full((b_, t_out, f_out, c_out), float("nan"))
    hits = torch.zeros(out.shape, dtype=torch.int64)
    parts = torch.zeros((b_, plan.tiles, 2, c_out), dtype=torch.float64)
    slot = _slots(18, 34)
    assert sorted(slot.tolist()) == list(range(18 * 34))
    n_groups, seen = b_ * plan.tiles, []

    def raw_of(grp):
        if grp >= n_groups:
            return None, None
        b, tile = divmod(grp, plan.tiles)
        i0, j0 = (tile // tiles_f) * 16 - 1, (tile % tiles_f) * 32 - 1
        raw = torch.zeros((18, 34, c_in))
        ts = slice(max(i0, 0), min(i0 + 18, t_in))
        fs = slice(max(j0, 0), min(j0 + 34, f_in))
        raw[ts.start - i0:ts.stop - i0, fs.start - j0:fs.stop - j0] = \
            xs[b, ts, fs]
        return grp, raw

    for z in range(plan.groups):
        cos = slice(z * co_n, (z + 1) * co_n)
        wbuf = wt[:, :, cos].reshape(16, co_n, planes, 16).permute(0, 2, 1, 3)
        for blk in range(min(grid, n_groups)):
            buf = raw_of(blk)
            for grp in range(blk, n_groups, grid):
                held, raw = buf
                assert held == grp, "the raw buffer holds this group"
                seen.append((z, grp))
                b, tile = divmod(grp, plan.tiles)
                t0, f0 = (tile // tiles_f) * 8, (tile % tiles_f) * 16
                amax = raw.abs().max().clamp_min(1e-30)
                inv = torch.full_like(amax, 127.0) / amax
                s_q = amax * (1.0 / 127.0)
                q = torch.round(raw * inv).clamp_(-127, 127)
                buf = raw_of(grp + grid)  # the prefetch, after the requant
                qbuf = torch.empty((planes, 18 * 34, 16))
                qbuf[:, slot] = q.reshape(18 * 34, planes, 16).permute(1, 0, 2)
                sc = s_q * w_scale[cos].float()
                s1 = torch.zeros(co_n, dtype=torch.float64)
                s2 = torch.zeros(co_n, dtype=torch.float64)
                for warp in range(8):
                    if t0 + warp >= t_out:  # a ragged tile's masked row
                        continue
                    acc = torch.zeros((16, co_n), dtype=torch.float64)
                    for tap in range(16):
                        dt, df = divmod(tap, 4)
                        rows = ((2 * warp + dt) * 34 + (df & 1) * 17
                                + (df >> 1) + torch.arange(16))
                        a = qbuf[:, rows].permute(1, 0, 2).reshape(16, c_in)
                        bw = wbuf[tap].permute(1, 0, 2).reshape(co_n, c_in)
                        acc += a.double() @ bw.double().T
                    ot, of = t0 + warp, f0 + torch.arange(16)
                    ok = of < f_out
                    o = (acc.float() * sc + bias[cos].float())[ok]
                    out[b, ot, of[ok], cos] = o
                    hits[b, ot, of[ok], cos] += 1
                    s1 += o.double().sum(0)
                    s2 += (o.double() ** 2).sum(0)
                parts[b, tile, 0, cos], parts[b, tile, 1, cos] = s1, s2
    assert sorted(seen) == [(z, g) for z in range(plan.groups)
                            for g in range(n_groups)], "each group once"
    assert torch.all(hits == 1), "every output written by exactly one warp"
    tot = parts.sum(dim=1)
    return (out.to(x.dtype).reshape(b_, t_out, f_out * c_out), tot[:, 0],
            tot[:, 1])


# (B, T_in, F_in, C_in, C_out, grid cap): 32→64 with ragged output tiles
# (T/2 no multiple of 8, F/2 none of 16), F = 8 (f_out 4 and 8), 64→96
# (three groups of 32 output channels), 64→128 (two of 64), fewer blocks
# than groups, one block
DOWNI8_CASES = [(2, 20, 40, 32, 64, 5), (1, 16, 16, 32, 64, 3),
                (3, 10, 8, 32, 64, 4), (2, 18, 24, 64, 96, 2),
                (1, 34, 36, 64, 128, 7), (2, 12, 66, 32, 32, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,f,c_in,c_out,grid", DOWNI8_CASES)
def test_conv_down_int8_walk_bit_equal_to_plain(b, t, f, c_in, c_out, grid,
                                                dtype):
    rng = np.random.default_rng(t * f + c_in)

    def r(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale)
                                .astype(np.float32))
    x = r(b, t, f * c_in).to(dtype)
    wq, s_w = quantize_strided_weights_int8(r(4, 4, c_in, c_out,
                                              scale=(16 * c_in) ** -0.5))
    bias = r(c_out)
    got = emulate_conv_down_int8(x, wq, s_w, bias, c_in=c_in, c_out=c_out,
                                 grid_cap=grid)
    ref = conv_down_flat_int8_plain(x, wq, s_w, bias, c_in=c_in, c_out=c_out,
                                    want_stats=True)
    assert torch.equal(got[0], ref[0])
    _close(got[1:], ref[1:], 1e-5)


def test_down_int8_weights_prepared_and_twin_unchanged():
    """prepare_params gives the int8 down transition ``wq_t``, the
    [4, 4, C_out, C_in] copy the kernel reads, which swaps back to ``wq``
    exactly; ``conv3x3_taps`` hands it to ``conv_down_flat``; the twin, which
    reads HWIO ``wq``, gives the same bits with and without it; the kernel's
    plan takes every int8 down transition the model can pick (C_in 32 or
    64)."""
    tcfg = dict2namespace({
        "module": "fnet",
        "kwargs": {"hidden_size": 32, "num_hidden_layers": 1,
                   "intermediate_size": 64, "hidden_act": "gelu_new",
                   "hidden_dropout_prob": 0.1, "initializer_range": 0.02,
                   "layer_norm_eps": 1e-6},
        "channels": 32, "dtype": None, "fourier_impl": "dft_matmul"})
    cfg = unet.ModelConfig(channels=2, f_size=64, ch=(32, 64, 96, 128, 192,
                                                      256),
                           krn=(3,) * 6, res=(1,) * 6, num_timesteps=50,
                           transformers=tcfg, strided_int8=True)
    params = unet.init_model(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    prepared = unet.prepare_params(params, cfg)
    seen = []
    for i, stage in enumerate(prepared["down_modules"]["stages"]):
        if "down" not in stage or "wq" not in stage["down"]:
            continue
        conv = stage["down"]
        wq, wq_t = conv["wq"], conv["wq_t"]
        c_in, c_out = wq.shape[2], wq.shape[3]
        seen.append((c_in, c_out))
        assert wq_t.dtype == torch.int8 and wq_t.is_contiguous()
        assert tuple(wq_t.shape) == (4, 4, c_out, c_in)
        assert torch.equal(wq_t.permute(0, 1, 3, 2), wq)
        w, kw = conv3x3_taps(conv, cfg.dtype, True)
        assert w is wq and kw["wq_t"] is wq_t
        x = torch.randn(1, 16, 32 * c_in, generator=torch.Generator()
                        .manual_seed(i))
        a = conv_down_flat(x, wq, conv["b"], c_in=c_in, c_out=c_out,
                           want_stats=True, w_scale=kw["w_scale"])
        b = conv_down_flat(x, wq, conv["b"], c_in=c_in, c_out=c_out,
                           want_stats=True, **kw)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    # the int8 down transition of these widths (strided_int8_transition):
    # 32→64, as at audio.yml
    assert seen == [(32, 64)]
    for c_in, c_out in ((32, 64), (32, 128), (64, 128), (64, 512)):
        assert unet.strided_int8_transition(cfg, c_in, c_out)
        for bf16 in (True, False):
            assert conv_down_int8_plan(16, 32, c_in, c_out, bf16).variant \
                == VARIANT_MMA
    assert not unet.strided_int8_transition(cfg, 96, 128)


# ------------------------------------------------- down dW, split TF32 ----

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 → TF32 as ``cvt.rna.tf32.f32``: the magnitude rounded to 10
    explicit mantissa bits, ties away from zero (half an ulp added to the
    sign-magnitude bits, the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x (fp32) = hi + lo to about 2^-22 of |x|, both TF32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def emulate_conv_down_dw(x, g, *, c_in, c_out, products="exact"):
    """conv_dw_tf32_kernel in mode 1. Block (group, share): input channels
    16·(group / (C_out / 32)) …, output channels 32·(group % (C_out / 32))
    …, all 16 taps, position tiles share·per … of the batch's (per =
    ceil(tiles / split)); per tile the raw x halo (rows 2·t0 − 1 …, columns
    2·f0 − 1 …, zero outside) and g tile (zero outside) go to their planes,
    the x halo's rows even columns first (slot r·HW + (c & 1)·HW/2 + c / 2);
    tap (kh, kw) of base position (i, j) reads x slot (2i + kh)·HW + (kw &
    1)·HW/2 + j + kw / 2 and g slot i·FT + j; a tile's sum (``sum``) is
    folded into the block's total at the tile's end; the shares' partials
    are summed in order. products: "exact" (fp64, the operands as stored),
    "split" (the split-TF32 products x_lo·g_hi + x_hi·g_lo + x_hi·g_hi,
    exact in fp64, a tile's sum rounded to fp32 and folded by fp32
    additions) or "tf32" (x_hi·g_hi alone, single-pass TF32)."""
    b_, t_in, fc = x.shape
    f_in = fc // c_in
    tb, fb = t_in // 2, f_in // 2
    plan = conv_down_dw_plan(t_in, f_in, c_in, c_out, False, b_)
    assert plan.variant == VARIANT_TF32
    tt, ft = plan.tile_t, plan.tile_f
    hr, hw = 2 * tt + 2, 2 * ft + 2
    tiles_f = _cdiv(fb, ft)
    per_sample = _cdiv(tb, tt) * tiles_f
    assert plan.tiles == b_ * per_sample
    per = _cdiv(plan.tiles, plan.split)
    assert _cdiv(plan.tiles, per) == plan.split, "no share is empty"
    assert plan.groups * plan.split <= 2 * 132 or plan.split == 1
    xs = x.view(b_, t_in, f_in, c_in)  # fp64 for "exact", else fp32
    gs = g.view(b_, tb, fb, c_out)
    if products == "exact":
        srcs = {"x": (xs.double(),), "g": (gs.double(),)}
        terms = [(0, 0)]
    else:
        srcs = {"x": tuple(v.double() for v in split_tf32(xs)),
                "g": tuple(v.double() for v in split_tf32(gs))}
        terms = [(0, 0)] if products == "tf32" else [(1, 0), (0, 1), (0, 0)]
    xslot = _slots(hr, hw)
    p = torch.arange(tt * ft)
    il, jl = p // ft, p % ft
    # the x slots of every tap × base position, and the g slots
    taps = torch.arange(16)
    kh, kw = taps // 4, taps % 4
    ax = ((2 * il[None] + kh[:, None]) * hw + (kw[:, None] & 1) * (hw // 2)
          + jl[None] + (kw[:, None] >> 1))
    part = torch.zeros((plan.split, 4, 4, c_in, c_out), dtype=torch.float64)
    co_groups = c_out // DW_TF32_CO
    for grp in range(plan.groups):
        ci = slice((grp // co_groups) * DW_TF32_CI,
                   (grp // co_groups + 1) * DW_TF32_CI)
        co = slice((grp % co_groups) * DW_TF32_CO,
                   (grp % co_groups + 1) * DW_TF32_CO)
        for share in range(plan.split):
            acc = torch.zeros((16, DW_TF32_CI, DW_TF32_CO),
                              dtype=torch.float64)
            for tile in range(share * per, min((share + 1) * per,
                                               plan.tiles)):
                b, r = divmod(tile, per_sample)
                t0, f0 = (r // tiles_f) * tt, (r % tiles_f) * ft
                xplane, gplane = [], []
                for v in srcs["x"]:
                    raw = torch.zeros((hr, hw, DW_TF32_CI),
                                      dtype=torch.float64)
                    ts = slice(max(2 * t0 - 1, 0), min(2 * t0 - 1 + hr, t_in))
                    fs = slice(max(2 * f0 - 1, 0), min(2 * f0 - 1 + hw, f_in))
                    raw[ts.start - 2 * t0 + 1:ts.stop - 2 * t0 + 1,
                        fs.start - 2 * f0 + 1:fs.stop - 2 * f0 + 1] = \
                        v[b, ts, fs, ci]
                    plane = torch.empty((hr * hw, DW_TF32_CI),
                                        dtype=torch.float64)
                    plane[xslot] = raw.reshape(-1, DW_TF32_CI)
                    xplane.append(plane)
                for v in srcs["g"]:
                    raw = torch.zeros((tt, ft, DW_TF32_CO),
                                      dtype=torch.float64)
                    tg = slice(t0, min(t0 + tt, tb))
                    fg = slice(f0, min(f0 + ft, fb))
                    raw[:tg.stop - t0, :fg.stop - f0] = v[b, tg, fg, co]
                    gplane.append(raw.reshape(-1, DW_TF32_CO))
                tile_sum = torch.zeros_like(acc)
                for xi, gi in terms:
                    tile_sum += torch.einsum("tpi,po->tio", xplane[xi][ax],
                                             gplane[gi][p])
                if products == "exact":
                    acc += tile_sum
                else:  # the kernel's fold: fp32 additions
                    acc = (acc.float() + tile_sum.float()).double()
            part[share, :, :, ci, co] = acc.view(4, 4, DW_TF32_CI, DW_TF32_CO)
    if products == "exact":
        return part.sum(dim=0)
    return part.float().sum(dim=0)  # the wrapper's sum of the partials


# (B, T_in, F_in, C_in, C_out): 32→64 with several shares, ragged T and F
# (base 6 × 18: tiles of 4 × 16 half empty), base F = 8 and 4 (tiles of
# 8 × 8), 64→96 (three output groups), 96→128 ragged, 192→256 at base F = 8
DW_CASES = [(1, 16, 32, 32, 64), (2, 12, 36, 32, 64), (3, 8, 16, 64, 96),
            (1, 10, 8, 32, 64), (1, 18, 34, 96, 128), (1, 8, 16, 192, 256)]


@pytest.mark.parametrize("b,t,f,c_in,c_out", DW_CASES)
def test_conv_down_dw_block_model_matches_plain(b, t, f, c_in, c_out):
    rng = np.random.default_rng(c_in + f + t)

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s))
    x, g = r(b, t, f * c_in), r(b, t // 2, (f // 2) * c_out)
    got = emulate_conv_down_dw(x, g, c_in=c_in, c_out=c_out)
    ref = conv_down_dw_flat_plain(x, g, c_in=c_in, c_out=c_out)
    _close([got], [ref], 1e-12)


def test_split_tf32_dw_model_matches_jax_kernel_in_fp32():
    """The block model with the split-TF32 products against the JAX
    package's down dW kernel (f32, Pallas interpret mode, unpacked through
    the packer's VJP as ``ddim_audio_tpu/ops/flat_grad.py`` does) at a tiny
    shape: within 2e-6 of max|JAX| (the fp64 model reads about 1e-7);
    single-pass TF32 (hi·hi) lands at least ten times further off. The
    tensor cores' own accumulation order is not modelled (the card's check:
    chip_smoke.py, at most 1e-4 relative)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ddim_audio_tpu.ops import flat_grad as jfg
    from ddim_audio_tpu.ops.pallas.conv_strided import pack_down_weights12

    b, t, f, c_in, c_out = 2, 16, 16, 32, 64
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, t, f * c_in)).astype(np.float32)
    g = rng.standard_normal((b, t // 2, (f // 2) * c_out)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        packed = jfg.conv_down_dw_flat(jnp.asarray(x), jnp.asarray(g),
                                       c_in=c_in, c_out=c_out)
    _, unpack = jax.vjp(pack_down_weights12,
                        jnp.zeros((4, 4, c_in, c_out), jnp.float32))
    ref = np.asarray(unpack(packed)[0], dtype=np.float64)
    scale = np.abs(ref).max()
    args = (torch.from_numpy(x), torch.from_numpy(g))
    errs = {}
    for products in ("exact", "split", "tf32"):
        got = emulate_conv_down_dw(*args, c_in=c_in, c_out=c_out,
                                   products=products)
        errs[products] = np.abs(got.double().numpy() - ref).max() / scale
    assert errs["exact"] <= 1e-6, errs
    assert errs["split"] <= 2e-6, errs
    assert errs["tf32"] >= 10 * errs["split"], errs


# --------------------------------------------------- on the card (gpu) ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,f,c_in,c_out", [
    (1, 8192, 256, 32, 64), (2, 20, 40, 32, 64), (3, 10, 8, 32, 64),
    (2, 18, 24, 64, 96), (1, 34, 36, 64, 128), (2, 12, 66, 32, 32),
    (2, 20, 40, 96, 64), (1, 18, 34, 256, 192)])
def test_int8_down_kernels_match_twin_on_gpu(cuda, b, t, f, c_in, c_out,
                                             dtype):
    """Bit-equal to the twin (the kernel's own group), statistics within
    1e-3, twice bit-equal, with and without the prepared weights, and the
    plan of the Python model (the two-pass kernel at C_in 96 and 256)."""
    from ddim_audio_tpu_torch.ops import _cuda

    bf16 = int(dtype == torch.bfloat16)
    assert library_plan(_cuda.kernels().ddim_conv_down_int8_plan, t, f, c_in,
                        c_out, bf16, b) == \
        conv_down_int8_plan(t, f, c_in, c_out, bool(bf16), b)
    g = torch.Generator(device=cuda).manual_seed(t + c_in)
    x = torch.randn(b, t, f * c_in, generator=g, device=cuda).to(dtype)
    wq, s_w = quantize_strided_weights_int8(
        torch.randn(4, 4, c_in, c_out, generator=g, device=cuda))
    bias = torch.randn(c_out, generator=g, device=cuda)
    kw = dict(c_in=c_in, c_out=c_out, want_stats=True)
    got = conv_down_flat_int8(x, wq, s_w, bias, wq_t=int8_weights_co_ci(wq),
                              **kw)
    again = conv_down_flat_int8(x, wq, s_w, bias, **kw)
    ref = conv_down_flat_int8_plain(x, wq, s_w, bias, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert torch.equal(got[0], ref[0])
    assert max(_rel(got[1], ref[1]), _rel(got[2], ref[2])) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,f,c_in,c_out", [
    (1, 1024, 256, 32, 64), (1, 512, 128, 64, 96), (1, 256, 64, 96, 128),
    (1, 128, 32, 128, 192), (1, 64, 16, 192, 256), (2, 12, 36, 32, 64),
    (3, 8, 16, 64, 96), (1, 10, 8, 32, 64)])
def test_fp32_down_dw_split_tf32_kernel_matches_twin_on_gpu(cuda, b, t, f,
                                                            c_in, c_out):
    """Within 1e-4 of max|twin| (cuBLAS fp32, TF32 off), twice bit-equal,
    the split-TF32 variant, the plan of the Python model and its partials'
    count."""
    from ddim_audio_tpu_torch.ops import _cuda

    lib = _cuda.kernels()
    plan = conv_down_dw_plan(t, f, c_in, c_out, False, b)
    assert library_plan(lib.ddim_conv_down_dw_plan, t, f, c_in, c_out, 0,
                        b) == plan
    assert plan.variant == VARIANT_TF32
    assert lib.ddim_conv_dw_splits(1, b, t, f, c_in, c_out, 0) == plan.split
    g = torch.Generator(device=cuda).manual_seed(t + c_in)
    x = torch.randn(b, t, f * c_in, generator=g, device=cuda)
    gr = torch.randn(b, t // 2, (f // 2) * c_out, generator=g, device=cuda)
    got = conv_down_dw_flat(x, gr, c_in=c_in, c_out=c_out)
    again = conv_down_dw_flat(x, gr, c_in=c_in, c_out=c_out)
    ref = conv_down_dw_flat_plain(x, gr, c_in=c_in, c_out=c_out)
    assert torch.equal(got, again)
    assert _rel(got, ref) <= 1e-4
