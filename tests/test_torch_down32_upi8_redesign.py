"""The split-TF32 fp32 down conv and the persistent int8-tap up conv, on the
CPU.

The CUDA kernels (``csrc/conv_strided.cu`` ``conv_down_tf32_kernel``,
``csrc/conv_strided_int8.cu`` ``conv_up_int8_kernel``) run only on the
card. What surrounds their arithmetic is checked here (their tile plans
against ``csrc/conv_plan.cu``: tests/test_torch_conv_redesign.py):

- a model of the fp32 down conv's blocks, walking the grid of its plan as
  the kernel does: one output-channel group a block (grid.z), the input
  halo streamed in 16-channel chunks through two buffers (each row's even
  columns before its odd ones), the ring's steps (chunk, tap row) with
  their four taps, a step's sum folded into the block's total, the chunks
  split over a cluster's ranks and summed in rank order, stores
  masked at ragged edges, f_out = 8, per-tile statistics partials; in fp64
  against the plain twin, and with the split-TF32 products (each operand
  rounded to a 10-bit mantissa, nearest-away, hi + lo, then lo·hi + hi·lo +
  hi·hi) against the JAX package's ``conv_down_flat`` in f32 under Pallas
  interpret mode, where single-pass TF32 is shown to fall short;
- a model of the int8 up kernel's persistent walk (blocks over
  quantisation groups, the one raw buffer holding the group being computed
  and then the prefetched next one, each warp's parity class and
  positions, the quad-transposed epilogue in the twin's operation order)
  bit-equal to ``conv_up_flat_int8_plain``;
- the [4, 4, C_out, C_in] int8 weights that ``prepare_params`` makes for the
  up kernel, as a round trip, and the twin fed from the prepared tree
  unchanged.

The module imports no JAX at top level (the JAX test imports it inside), so
its ``gpu`` tests run on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_down32_upi8_redesign.py -m
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
    conv_down_flat_plain,
    conv_up_flat,
    conv_up_flat_int8,
    conv_up_flat_int8_plain,
    quantize_strided_weights_int8,
)
from ddim_audio_tpu_torch.ops.flat_resblock import conv3x3_taps
from ddim_audio_tpu_torch.ops.tile_plan import (
    DOWN_TAPS,
    FILL_BLOCKS,
    TF32_K,
    UP_I8_CO,
    VARIANT_MMA,
    VARIANT_TF32,
    conv_down_plan,
    conv_up_int8_plan,
    library_plan,
)

torch.set_num_threads(2)


def _close(got, ref, tol):
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        assert err <= tol, err


# ------------------------------------------------ fp32 down, split TF32 --

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


def emulate_conv_down_tf32(x, w, bias, *, c_in, c_out, products="exact"):
    """conv_down_tf32_kernel's grid. Per block (tile, b, g): output channels
    g·NB … (NB = 64 where C_out allows, else 32), TT × FT output positions
    at tile coordinates (p / FT, p % FT); step s = 4·kc + dt stages tap row
    dt × input channels 16·kc … and, when dt = 0, chunk kc's halo (input
    rows 2·t0 − 1 …, columns 2·f0 − 1 …, zero outside; column hc at slot
    (hc % 2)·(FT + 1) + hc / 2 of its row) into buffer kc % 2; tap (dt, df)
    of a position reads slot base + dt·HW + (df % 2)·(FT + 1) + df / 2. A
    step's sum (acc_s) is folded into the block's sum at the step's end;
    where the plan splits K (grid.z = group · ksplit + rank), each rank takes
    its share of the chunks and rank 0 adds the ranks' sums in rank order;
    stores masked to the array; per-tile partials of the biased output.
    products: "exact" (fp64, the operands as stored), "split" (the
    split-TF32 products lo·hi + hi·lo + hi·hi, exact in fp64, a step's sum
    rounded to fp32 and folded by fp32 additions) or "tf32" (hi·hi alone,
    single-pass TF32, for contrast)."""
    b_, t_in, fc = x.shape
    f_in = fc // c_in
    t_out, f_out = t_in // 2, f_in // 2
    plan = conv_down_plan(t_in, f_in, c_in, c_out, False, b_)
    assert plan.variant == VARIANT_TF32 and plan.split % plan.groups == 0
    ksplit = plan.split // plan.groups
    tt, ft = plan.tile_t, plan.tile_f
    nb = c_out // plan.groups
    hw, half = 2 * ft + 2, ft + 1
    # the staged operands and the products of a tap: (halo source, weight)
    if products == "exact":
        srcs = {"x": x.double()}
        terms = [("x", w.double())]
    else:
        (xh, xl), (wh, wl) = split_tf32(x), split_tf32(w)
        srcs = {"hi": xh.double(), "lo": xl.double()}
        terms = [("hi", wh.double())] if products == "tf32" else [
            ("lo", wh.double()), ("hi", wl.double()), ("hi", wh.double())]
    srcs = {k: v.view(b_, t_in, f_in, c_in) for k, v in srcs.items()}
    out = torch.full((b_, t_out, f_out, c_out), float("nan"),
                     dtype=torch.float64)
    hits = torch.zeros(out.shape, dtype=torch.int64)
    parts = torch.zeros((b_, plan.tiles, 2, c_out), dtype=torch.float64)
    p = torch.arange(tt * ft)
    to_l, fo_l = p // ft, p % ft
    base = 2 * to_l * hw + fo_l
    hr, hc = torch.arange(2 * tt + 2), torch.arange(hw)
    slot = (hr[:, None] * hw + (hc % 2) * half + hc // 2).reshape(-1)
    assert sorted(slot.tolist()) == list(range((2 * tt + 2) * hw))
    chunks, tiles_f = c_in // TF32_K, -(-f_out // ft)

    def halo_of(src, b, t0, f0, kc):
        raw = torch.zeros((2 * tt + 2, hw, TF32_K), dtype=torch.float64)
        ts = slice(max(2 * t0 - 1, 0), min(2 * t0 + 2 * tt + 1, t_in))
        fs = slice(max(2 * f0 - 1, 0), min(2 * f0 + 2 * ft + 1, f_in))
        raw[ts.start - 2 * t0 + 1:ts.stop - 2 * t0 + 1,
            fs.start - 2 * f0 + 1:fs.stop - 2 * f0 + 1] = \
            src[b, ts, fs, kc * TF32_K:(kc + 1) * TF32_K]
        halo = torch.empty((len(slot), TF32_K), dtype=torch.float64)
        halo[slot] = raw.reshape(-1, TF32_K)
        return halo

    for b in range(b_):
        for tile in range(plan.tiles):
            t0, f0 = (tile // tiles_f) * tt, (tile % tiles_f) * ft
            valid = (t0 + to_l < t_out) & (f0 + fo_l < f_out)
            for z in range(plan.split):  # grid.z: group, K split rank
                g, kz = divmod(z, ksplit)
                cos = slice(g * nb, (g + 1) * nb)
                buffers = [None, None]  # (chunk, halos) of the two buffers
                # the block's sum: fp64 for the exact products, else fp32
                # as the kernel's registers, each step's sum rounded to fp32
                # and added by an fp32 addition
                acc = torch.zeros((tt * ft, nb), dtype=torch.float64)
                lo, hi = kz * chunks // ksplit, (kz + 1) * chunks // ksplit
                assert hi - lo >= min(2, chunks)
                for s in range(4 * lo, 4 * hi):
                    kc, dt = divmod(s, 4)
                    if dt == 0:  # staged with the chunk's first step
                        buffers[kc % 2] = (kc, {
                            k: halo_of(v, b, t0, f0, kc)
                            for k, v in srcs.items()})
                    chunk, halos = buffers[kc % 2]
                    assert chunk == kc, "a chunk's halo outlives its steps"
                    cis = slice(kc * TF32_K, (kc + 1) * TF32_K)
                    acc_s = torch.zeros((tt * ft, nb), dtype=torch.float64)
                    for df in range(DOWN_TAPS):
                        off = dt * hw + (df & 1) * half + (df >> 1)
                        for src, wt in terms:
                            acc_s += halos[src][base + off] @ \
                                wt[dt, df][cis, cos]
                    if products == "exact":
                        acc += acc_s
                    else:
                        acc = (acc.float() + acc_s.float()).double()
                # the cluster's rank 0 adds the ranks' sums in rank order
                if kz == 0:
                    total = torch.zeros_like(acc)
                if products == "exact":
                    total += acc
                else:
                    total = (total.float() + acc.float()).double()
                if kz < ksplit - 1:
                    continue
                acc = total
                if products == "exact":
                    o = (acc + bias.double()[cos])[valid]
                else:  # the kernel's fp32 epilogue
                    o = (acc.float() + bias.float()[cos]).double()[valid]
                oi, oj = t0 + to_l[valid], f0 + fo_l[valid]
                out[b, oi, oj, cos] = o
                hits[b, oi, oj, cos] += 1
                parts[b, tile, 0, cos] = o.sum(0)
                parts[b, tile, 1, cos] = (o * o).sum(0)
    assert torch.all(hits == 1), "every output written by exactly one block"
    tot = parts.sum(dim=1)
    return out.reshape(b_, t_out, f_out * c_out), tot[:, 0], tot[:, 1]


# (B, T_in, F_in, C_in, C_out): 192→256 at f_out = 8 (8 × 8 tiles, four
# groups, the chunks split over six blocks), 32→64 with ragged T and F,
# 64→96 at f_out < 16 (groups of 32), 96→128 and 128→192 (tiles of 4 × 16,
# split K), and a sample whose grid takes the 128-position tile (MT = 2)
DOWN32_CASES = [(1, 16, 16, 192, 256), (2, 12, 36, 32, 64), (1, 10, 20, 64, 96),
                (1, 18, 34, 96, 128), (1, 8, 32, 128, 192),
                (1, 544, 256, 32, 64)]


@pytest.mark.parametrize("b,t,f,c_in,c_out", DOWN32_CASES)
def test_conv_down_tf32_block_model_matches_plain(b, t, f, c_in, c_out):
    rng = np.random.default_rng(c_in + f + t)

    def r(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s) * scale)
    x, w = r(b, t, f * c_in), r(4, 4, c_in, c_out, scale=(16 * c_in) ** -0.5)
    bias = r(c_out)
    # 32·(8 / WN) positions a block (MT = 2) where one sample's grid of
    # them reaches FILL_BLOCKS, else half as many (MT = 1)
    plan = conv_down_plan(t, f, c_in, c_out, False, b)
    mt2 = 32 * (8 // (2 if c_out % 64 == 0 else 1))
    ft = 16 if f // 2 >= 16 else 8
    full = -(-(t // 2) // (mt2 // ft)) * -(-(f // 2) // ft) * plan.groups \
        >= FILL_BLOCKS
    assert (plan.tile_t * plan.tile_f, plan.tile_f) == \
        (mt2 if full else mt2 // 2, ft)
    assert full == (t == 544)
    assert (plan.split // plan.groups > 1) == (t != 544 and c_in > 32)
    got = emulate_conv_down_tf32(x, w, bias, c_in=c_in, c_out=c_out)
    ref = conv_down_flat_plain(x, w, bias, c_in=c_in, c_out=c_out,
                               want_stats=True)
    _close(got, ref, 1e-12)


def test_tf32_split_rounds_nearest_away_and_keeps_22_bits():
    """tf32_rna is cvt.rna's rounding (ties away from zero), hi + lo holds x
    to 2^-22 of |x|, zeros and denormal-free small values split cleanly."""
    one = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12,
                        1.0 + 3 * 2 ** -11], dtype=torch.float32)
    assert tf32_rna(one).tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                                      1.0 + 2 ** -9]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32)) * 1e3
    x[:3] = torch.tensor([0.0, -0.0, 1e-30])
    hi, lo = split_tf32(x)
    for v in (hi, lo):
        assert torch.all(v.view(torch.int32) & 0x1FFF == 0)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert torch.all(err <= 2.0 ** -22 * x.double().abs())
    assert hi[0] == 0 and lo[0] == 0 and lo[1] == 0


def test_split_tf32_model_matches_jax_kernel_in_fp32():
    """The block walk with the split-TF32 products against the JAX
    package's down kernel (f32, Pallas interpret mode) at a tiny shape:
    within 2e-6 of max|JAX| (fp32 accuracy: the fp64 model reads about
    1e-7); single-pass TF32 (hi·hi) lands at least ten times further off.
    The tensor cores' own accumulation order is not modelled (the card's
    check: chip_smoke.py, at most 1e-4 relative and 100 dB a call)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ddim_audio_tpu.ops.pallas.conv_strided import (
        conv_down_flat as jax_conv_down,
        pack_down_weights,
    )

    b, t, f, c_in, c_out = 1, 16, 32, 32, 64
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, t, f * c_in)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c_in, c_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, r1, r2 = jax_conv_down(
            jnp.asarray(x), pack_down_weights(jnp.asarray(w)), bias,
            c_in=c_in, c_out=c_out, tile_t=4, want_stats=True)
    ref = np.asarray(ref, dtype=np.float64)
    scale = np.abs(ref).max()
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    errs, stats = {}, {}
    for products in ("exact", "split", "tf32"):
        out, *stats[products] = emulate_conv_down_tf32(
            *args, c_in=c_in, c_out=c_out, products=products)
        errs[products] = np.abs(out.numpy() - ref).max() / scale
    fold = [np.asarray(s).reshape(b, -1, c_out).sum(axis=1) for s in (r1, r2)]
    for got, want in zip(stats["split"], fold):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert errs["exact"] <= 1e-6, errs
    assert errs["split"] <= 2e-6, errs
    assert errs["tf32"] >= 10 * errs["split"], errs


# ------------------------------------------------ int8-tap up, persistent --

def emulate_conv_up_int8(x, wq, w_scale, bias, *, c_in, c_out, residual,
                         grid):
    """conv_up_int8_kernel's walk: for each output-channel group z
    (UP_I8_CO channels, grid.z), block i of ``grid`` takes quantisation
    groups i, i + grid, …; one raw buffer holds the group being computed
    (staged before the walk, then by the prefetch issued after the amax);
    the amax and requant are the twin's (the 6 × 10 input positions of the
    group, zero outside); warp w owns parity
    class (py, px) = (w >> 2, (w >> 1) & 1) at input rows 2·(w & 1) + r of
    the tile, columns gid, its four taps from the [4, 4, C_out, C_in]
    weights; the epilogue the twin's fp32 operations in the twin's order:
    float(acc) · (s_q · w_scale) + bias + residual."""
    b_, t_in, fc = x.shape
    f_in = fc // c_in
    t_out, f_out = 2 * t_in, 2 * f_in
    plan = conv_up_int8_plan(t_in, f_in, c_in, c_out, x.dtype == torch.bfloat16,
                             b_)
    assert plan.variant == VARIANT_MMA
    tiles_f = -(-f_out // 16)
    xs = x.float().view(b_, t_in, f_in, c_in)
    wt = int8_weights_co_ci(wq).double()  # [4, 4, co, ci], as staged
    res = residual.float().view(b_, t_out, f_out, c_out)
    out = torch.full((b_, t_out, f_out, c_out), float("nan"))
    hits = torch.zeros(out.shape, dtype=torch.int64)
    parts = torch.zeros((b_, plan.tiles, 2, c_out), dtype=torch.float64)
    n_groups, seen = b_ * plan.tiles, []

    def raw_of(grp):
        if grp >= n_groups:
            return None, None
        b, tile = divmod(grp, plan.tiles)
        i0, j0 = (tile // tiles_f) * 4 - 1, (tile % tiles_f) * 8 - 1
        raw = torch.zeros((6, 10, c_in))
        ts = slice(max(i0, 0), min(i0 + 6, t_in))
        fs = slice(max(j0, 0), min(j0 + 10, f_in))
        raw[ts.start - i0:ts.stop - i0, fs.start - j0:fs.stop - j0] = \
            xs[b, ts, fs]
        return grp, raw

    for z in range(plan.groups):
        cos = slice(z * UP_I8_CO, (z + 1) * UP_I8_CO)
        for blk in range(min(grid, n_groups)):
            buf = raw_of(blk)
            for grp in range(blk, n_groups, grid):
                held, raw = buf
                assert held == grp, "the raw buffer holds this group"
                seen.append((z, grp))
                b, tile = divmod(grp, plan.tiles)
                t0, f0 = (tile // tiles_f) * 8, (tile % tiles_f) * 16
                amax = raw.abs().max().clamp_min(1e-30)
                buf = raw_of(grp + grid)  # the prefetch, after the amax
                inv = torch.full_like(amax, 127.0) / amax
                s_q = amax * (1.0 / 127.0)
                q = torch.round(raw * inv).clamp_(-127, 127).double()
                sc = s_q * w_scale[cos].float()
                s1 = torch.zeros(UP_I8_CO, dtype=torch.float64)
                s2 = torch.zeros(UP_I8_CO, dtype=torch.float64)
                for warp in range(8):
                    py, px, hh = warp >> 2, (warp >> 1) & 1, warp & 1
                    m16 = torch.arange(16)
                    rows, cols = 2 * hh + m16 // 8, m16 % 8
                    acc = torch.zeros((16, UP_I8_CO), dtype=torch.float64)
                    for ab in range(4):
                        a, bb = ab >> 1, ab & 1
                        acc += q[rows + py + a, cols + px + bb] @ \
                            wt[py + 2 * a, px + 2 * bb][cos].T
                    ot, of = t0 + 2 * rows + py, f0 + 2 * cols + px
                    ok = (ot < t_out) & (of < f_out)
                    o = acc.float() * sc + bias[cos].float()
                    o = o[ok] + res[b, ot[ok], of[ok], cos]
                    out[b, ot[ok], of[ok], cos] = o
                    hits[b, ot[ok], of[ok], cos] += 1
                    s1 += o.double().sum(0)
                    s2 += (o.double() ** 2).sum(0)
                parts[b, tile, 0, cos], parts[b, tile, 1, cos] = s1, s2
    assert sorted(seen) == [(z, g) for z in range(plan.groups)
                            for g in range(n_groups)], "each group once"
    assert torch.all(hits == 1), "every output written by exactly one warp"
    tot = parts.sum(dim=1)
    return (out.to(x.dtype).reshape(b_, t_out, f_out * c_out), tot[:, 0],
            tot[:, 1])


# (B, T_in, F_in, C_in, C_out, grid): 64→32 and 256→192 (six groups of 32
# output channels) at small T, F; ragged output tiles (2T or 2F no multiple
# of 8 or 16); fewer blocks than groups
UPI8_CASES = [(2, 8, 16, 64, 32, 5), (1, 6, 8, 256, 192, 3),
              (2, 5, 12, 64, 32, 4), (1, 3, 7, 96, 64, 2),
              (2, 9, 20, 32, 64, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,f,c_in,c_out,grid", UPI8_CASES)
def test_conv_up_int8_walk_bit_equal_to_plain(b, t, f, c_in, c_out, grid,
                                              dtype):
    rng = np.random.default_rng(t * f + c_in)

    def r(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale)
                                .astype(np.float32))
    x = r(b, t, f * c_in).to(dtype)
    wq, s_w = quantize_strided_weights_int8(r(4, 4, c_in, c_out,
                                              scale=(4 * c_in) ** -0.5))
    bias, res = r(c_out), r(b, 2 * t, 2 * f * c_out).to(dtype)
    got = emulate_conv_up_int8(x, wq, s_w, bias, c_in=c_in, c_out=c_out,
                               residual=res, grid=grid)
    ref = conv_up_flat_int8_plain(x, wq, s_w, bias, c_in=c_in, c_out=c_out,
                                  residual=res, want_stats=True)
    assert torch.equal(got[0], ref[0])
    _close(got[1:], ref[1:], 1e-5)


def test_up_int8_weights_round_trip_and_twin_unchanged():
    """prepare_params gives every int8 up transition ``wq_t``, the
    [4, 4, C_out, C_in] copy the kernel reads, which swaps back to ``wq``
    exactly; ``conv3x3_taps`` hands it to ``conv_up_flat``; the twin, which
    reads HWIO ``wq``, gives the same bits with and without it."""
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
    for i, stage in enumerate(prepared["up_modules"]["stages"]):
        if "up" not in stage or "wq" not in stage["up"]:
            continue
        conv = stage["up"]
        wq, wq_t = conv["wq"], conv["wq_t"]
        c_in, c_out = wq.shape[2], wq.shape[3]
        seen.append((c_in, c_out))
        assert wq_t.dtype == torch.int8 and wq_t.is_contiguous()
        assert tuple(wq_t.shape) == (4, 4, c_out, c_in)
        assert torch.equal(wq_t.permute(0, 1, 3, 2), wq)
        w, kw = conv3x3_taps(conv, cfg.dtype, True)
        assert w is wq and kw["wq_t"] is wq_t
        x = torch.randn(1, 4, 8 * c_in, generator=torch.Generator()
                        .manual_seed(i))
        res = torch.randn(1, 8, 16 * c_out, generator=torch.Generator()
                          .manual_seed(i + 1))
        a = conv_up_flat(x, wq, conv["b"], c_in=c_in, c_out=c_out,
                         residual=res, want_stats=True,
                         w_scale=kw["w_scale"])
        b = conv_up_flat(x, wq, conv["b"], c_in=c_in, c_out=c_out,
                         residual=res, want_stats=True, **kw)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    # the int8 up transitions of these widths (strided_int8_transition):
    # 64→32 and 256→192, as at audio.yml
    assert sorted(seen) == [(64, 32), (256, 192)]


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
@pytest.mark.parametrize("b,t,f,c_in,c_out", [
    (1, 1024, 256, 32, 64), (1, 512, 128, 64, 96), (1, 256, 64, 96, 128),
    (1, 128, 32, 128, 192), (1, 64, 16, 192, 256), (2, 18, 34, 32, 64)])
def test_fp32_down_split_tf32_kernel_matches_twin_on_gpu(cuda, b, t, f, c_in,
                                                         c_out):
    """Within 1e-4 of max|twin| (cuDNN fp32, TF32 off), statistics within
    1e-3, twice bit-equal, the split-TF32 variant and the plan of the
    Python model."""
    from ddim_audio_tpu_torch.ops import _cuda

    lib = _cuda.kernels()
    assert library_plan(lib.ddim_conv_down_plan, t, f, c_in, c_out, 0, b) \
        == conv_down_plan(t, f, c_in, c_out, False, b)
    assert lib.ddim_conv_down_variant(t, f, c_in, c_out, 0) == VARIANT_TF32
    g = torch.Generator(device=cuda).manual_seed(t + c_in)
    x = torch.randn(b, t, f * c_in, generator=g, device=cuda)
    w = torch.randn(4, 4, c_in, c_out, generator=g, device=cuda) \
        * (16 * c_in) ** -0.5
    bias = torch.randn(c_out, generator=g, device=cuda)
    kw = dict(c_in=c_in, c_out=c_out, want_stats=True)
    got = conv_down_flat(x, w, bias, **kw)
    again = conv_down_flat(x, w, bias, **kw)
    ref = conv_down_flat_plain(x, w, bias, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert _rel(got[0], ref[0]) <= 1e-4
    assert max(_rel(got[1], ref[1]), _rel(got[2], ref[2])) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,f,c_in,c_out", [
    (1, 4096, 128, 64, 32), (2, 256, 8, 256, 192), (1, 9, 12, 64, 32),
    (2, 5, 20, 96, 64)])
def test_int8_up_persistent_kernel_matches_twin_on_gpu(cuda, b, t, f, c_in,
                                                       c_out, dtype):
    """Bit-equal to the twin (the kernel's own group), statistics within
    1e-3, twice bit-equal, with and without the prepared weights, and the
    plan of the Python model."""
    from ddim_audio_tpu_torch.ops import _cuda

    bf16 = int(dtype == torch.bfloat16)
    assert library_plan(_cuda.kernels().ddim_conv_up_int8_plan, t, f, c_in,
                        c_out, bf16, b) == \
        conv_up_int8_plan(t, f, c_in, c_out, bool(bf16), b)
    g = torch.Generator(device=cuda).manual_seed(t + c_in)
    x = torch.randn(b, t, f * c_in, generator=g, device=cuda).to(dtype)
    wq, s_w = quantize_strided_weights_int8(
        torch.randn(4, 4, c_in, c_out, generator=g, device=cuda))
    bias = torch.randn(c_out, generator=g, device=cuda)
    res = torch.randn(b, 2 * t, 2 * f * c_out, generator=g,
                      device=cuda).to(dtype)
    kw = dict(c_in=c_in, c_out=c_out, residual=res, want_stats=True)
    got = conv_up_flat_int8(x, wq, s_w, bias, wq_t=int8_weights_co_ci(wq),
                            **kw)
    again = conv_up_flat_int8(x, wq, s_w, bias, **kw)
    ref = conv_up_flat_int8_plain(x, wq, s_w, bias, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert torch.equal(got[0], ref[0])
    assert max(_rel(got[1], ref[1]), _rel(got[2], ref[2])) <= 1e-3
