"""Index math of the redesigned bf16 down conv and int8-tap conv3x3 kernels,
on the CPU.

The CUDA kernels (``csrc/conv_strided.cu`` ``conv_down_mma_kernel``,
``csrc/conv3x3_int8.cu`` ``conv3x3_int8_kernel``) run only on the card. What
surrounds their arithmetic is checked here (their tile plans against
``csrc/conv_plan.cu``: tests/test_torch_conv_redesign.py):

- a model of the down conv's blocks, walking the grid of its plan as the
  kernel does (the input halo with each row's even columns before its odd
  ones, the tap offsets into it at stride 2, the ring's step order over tap
  pairs and 32-channel chunks, output-channel groups over grid.z, ragged
  edges, f_out = 8, per-tile statistics partials), against the plain twin in
  fp64 and against the JAX package's ``conv_down_flat`` in Pallas interpret
  mode at 192→256;
- a model of the int8 kernel's persistent walk over quantisation groups and
  of the positions and channels each warp owns, against the twin;
- the int8 weights' [3, 3, C_out, C_in] copy that ``prepare_params`` makes
  for the kernel, and that the twin fed from the prepared tree is unchanged.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.ops.pallas.conv_strided import (
    conv_down_flat as jax_conv_down,
    pack_down_weights,
)
from ddim_audio_tpu_torch.config import dict2namespace
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.ops.conv_flat import (
    _prologue,
    conv3x3_flat,
    conv3x3_flat_int8_plain,
    int8_weights_co_ci,
    quantize_conv_weights_int8,
)
from ddim_audio_tpu_torch.ops.conv_strided import conv_down_flat_plain
from ddim_audio_tpu_torch.ops.flat_resblock import conv3x3_taps
from ddim_audio_tpu_torch.ops.tile_plan import (
    DOWN_TAPS,
    VARIANT_MMA,
    conv3x3_int8_plan,
    conv_down_plan,
)

torch.set_num_threads(2)
MMA_K = 32


def _close(got, ref, tol):
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        assert err <= tol, err


def emulate_conv_down_mma(x, w, bias, *, c_in, c_out):
    """conv_down_mma_kernel's grid in fp64. Per block (tile, b, z): the halo
    of input rows 2·t0 − 1 … and columns 2·f0 − 1 … (zero outside) stored
    as the kernel stores it, column hc of a row at slot (hc % 2)·(FT + 1) +
    hc / 2; the block's 16·MT·WM output positions p at tile coordinates
    (p / FT, p % FT), each reading tap (dt, df) at slot (2·to + dt)·HW +
    (df % 2)·(FT + 1) + fo + df / 2 (the kernel's base + constant offset);
    the K loop in the ring's step order (chunk of DOWN_TAPS taps, then
    32-channel chunk)
    for the groups z, z + split, …; stores masked to the array; per-tile
    partials of the biased output."""
    b_, t_in, fc = x.shape
    f_in = fc // c_in
    t_out, f_out = t_in // 2, f_in // 2
    plan = conv_down_plan(t_in, f_in, c_in, c_out, True, b_)
    assert plan.variant == VARIANT_MMA
    tt, ft = plan.tile_t, plan.tile_f
    nb = c_out // plan.groups
    hw, half = 2 * ft + 2, ft + 1
    xs = x.double().view(b_, t_in, f_in, c_in)
    w64, b64 = w.double(), bias.double()
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
    kc_n, tiles_f = c_in // MMA_K, -(-f_out // ft)
    for b in range(b_):
        for tile in range(plan.tiles):
            t0, f0 = (tile // tiles_f) * tt, (tile % tiles_f) * ft
            raw = torch.zeros((2 * tt + 2, hw, c_in), dtype=torch.float64)
            ts = slice(max(2 * t0 - 1, 0), min(2 * t0 + 2 * tt + 1, t_in))
            fs = slice(max(2 * f0 - 1, 0), min(2 * f0 + 2 * ft + 1, f_in))
            raw[ts.start - 2 * t0 + 1:ts.stop - 2 * t0 + 1,
                fs.start - 2 * f0 + 1:fs.stop - 2 * f0 + 1] = xs[b, ts, fs]
            halo = torch.empty((len(slot), c_in), dtype=torch.float64)
            halo[slot] = raw.reshape(-1, c_in)
            valid = (t0 + to_l < t_out) & (f0 + fo_l < f_out)
            for z in range(plan.split):
                for g in range(z, plan.groups, plan.split):
                    cos = slice(g * nb, (g + 1) * nb)
                    acc = torch.zeros((tt * ft, nb), dtype=torch.float64)
                    for rem in range(16 // DOWN_TAPS * kc_n):
                        chunk, kc = divmod(rem, kc_n)
                        cis = slice(kc * MMA_K, (kc + 1) * MMA_K)
                        for j in range(DOWN_TAPS):
                            dt, df = divmod(DOWN_TAPS * chunk + j, 4)
                            off = dt * hw + (df & 1) * half + (df >> 1)
                            acc += halo[base + off, cis] @ w64[dt, df][cis, cos]
                    o = (acc + b64[cos])[valid]
                    oi, oj = t0 + to_l[valid], f0 + fo_l[valid]
                    out[b, oi, oj, cos] = o
                    hits[b, oi, oj, cos] += 1
                    parts[b, tile, 0, cos] = o.sum(0)
                    parts[b, tile, 1, cos] = (o * o).sum(0)
    assert torch.all(hits == 1), "every output written by exactly one block"
    tot = parts.sum(dim=1)
    return out.reshape(b_, t_out, f_out * c_out), tot[:, 0], tot[:, 1]


# (B, T_in, F_in, C_in, C_out): 192→256 at f_out = 8 (8 × 8 tiles, groups
# over grid.z), 32→64 with ragged T and F, 64→96 at f_out < 16 (32 × 8
# tiles, three groups of 32), 96→128 (8 × 16 tiles), 128→192 (groups over
# grid.z), 32→96 (256 positions a block), 128→96 (128 positions, groups of
# 32)
DOWN_CASES = [(1, 16, 16, 192, 256), (2, 12, 36, 32, 64), (2, 10, 20, 64, 96),
              (1, 18, 34, 96, 128), (2, 8, 64, 128, 192), (1, 6, 12, 32, 96),
              (1, 10, 34, 128, 96)]


@pytest.mark.parametrize("b,t,f,c_in,c_out", DOWN_CASES)
def test_conv_down_block_model_matches_plain(b, t, f, c_in, c_out):
    rng = np.random.default_rng(c_in + f)

    def r(*s, scale=1.0):
        return torch.from_numpy(rng.standard_normal(s) * scale)
    x, w = r(b, t, f * c_in), r(4, 4, c_in, c_out, scale=(16 * c_in) ** -0.5)
    bias = r(c_out)
    got = emulate_conv_down_mma(x, w, bias, c_in=c_in, c_out=c_out)
    ref = conv_down_flat_plain(x, w, bias, c_in=c_in, c_out=c_out,
                               want_stats=True)
    _close(got, ref, 1e-12)


def test_conv_down_block_model_matches_jax_kernel():
    """192→256 at f_out = 8 against the JAX kernel in interpret mode (the
    tolerances of the port's twin test of it)."""
    b, t, f, c_in, c_out = 2, 16, 16, 192, 256
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, t, f * c_in)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c_in, c_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, r1, r2 = jax_conv_down(
            jnp.asarray(x), pack_down_weights(jnp.asarray(w)), bias,
            c_in=c_in, c_out=c_out, tile_t=4, want_stats=True)
    out, s1, s2 = emulate_conv_down_mma(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        c_in=c_in, c_out=c_out)
    fold = [np.asarray(s).reshape(b, -1, c_out).sum(axis=1) for s in (r1, r2)]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), fold[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), fold[1], rtol=1e-5, atol=1e-4)


def emulate_conv3x3_int8(x, wq, w_scale, *, c, add, pre, grid):
    """conv3x3_int8_kernel's persistent walk in fp64: block i takes groups
    i, i + grid, …; each group (an 8 × 16 output tile of one sample) stages
    its 10 × 18 halo of prologue values (zero outside), quantises it with
    the group's own scale, and warp (wm, wn) of the block's 8 (C = 32,
    64) or 12 (C = 96) computes MT output rows × the 32 channels 32·wn …
    (C = 32: one row, else two) from the int8 halo and the [co, ci]
    weights; stores masked to the array, one row of statistics partials
    per group."""
    b_, t, fc = x.shape
    f = fc // c
    plan = conv3x3_int8_plan(t, f, c, x.dtype == torch.bfloat16, b_)
    tt, ft = plan.tile_t, plan.tile_f
    n_warps = (384 if c == 96 else 256) // 32
    wn_n = c // 32
    wm_n = n_warps // wn_n
    mt_n = tt * ft // (16 * wm_n)
    v = _prologue(x, c, None, pre, True, torch.bfloat16).double().view(
        b_, t, f, c)
    wt = int8_weights_co_ci(wq).double()  # [3, 3, co, ci]
    out = torch.full((b_, t, f, c), float("nan"), dtype=torch.float64)
    hits = torch.zeros(out.shape, dtype=torch.int64)
    parts = torch.zeros((b_, plan.tiles, 2, c), dtype=torch.float64)
    n_groups, seen = b_ * plan.tiles, []
    tiles_f = -(-f // ft)
    for blk in range(min(grid, n_groups)):
        for grp in range(blk, n_groups, grid):
            seen.append(grp)
            b, tile = divmod(grp, plan.tiles)
            t0, f0 = (tile // tiles_f) * tt, (tile % tiles_f) * ft
            halo = torch.zeros((tt + 2, ft + 2, c), dtype=torch.float64)
            ts = slice(max(t0 - 1, 0), min(t0 + tt + 1, t))
            fs = slice(max(f0 - 1, 0), min(f0 + ft + 1, f))
            halo[ts.start - t0 + 1:ts.stop - t0 + 1,
                 fs.start - f0 + 1:fs.stop - f0 + 1] = v[b, ts, fs]
            amax = max(halo.abs().max().item(), 1e-30)
            inv = torch.tensor(127.0) / torch.tensor(amax, dtype=torch.float32)
            s_q = torch.tensor(amax, dtype=torch.float32) * (1.0 / 127.0)
            q = torch.round(halo.float() * inv).clamp_(-127, 127).double()
            for warp in range(n_warps):
                wm, wn = warp % wm_n, warp // wm_n
                cos = slice(32 * wn, 32 * wn + 32)
                for mt in range(mt_n):
                    p = wm * 16 * mt_n + mt * 16 + torch.arange(16)
                    rows, cols = p // ft, p % ft
                    acc = torch.zeros((16, cos.stop - cos.start),
                                      dtype=torch.float64)
                    for tap in range(9):
                        dt, df = divmod(tap, 3)
                        acc += q[rows + dt, cols + df] @ wt[dt, df][cos].T
                    o = acc.float() * (s_q * w_scale[cos])
                    o = torch.nn.functional.silu(
                        o + add[b, cos].float()).double()
                    ok = (t0 + rows < t) & (f0 + cols < f)
                    oi, oj = t0 + rows[ok], f0 + cols[ok]
                    out[b, oi, oj, cos] = o[ok]
                    hits[b, oi, oj, cos] += 1
                    parts[b, tile, 0, cos] += o[ok].sum(0)
                    parts[b, tile, 1, cos] += (o[ok] * o[ok]).sum(0)
    assert sorted(seen) == list(range(n_groups)), "each group exactly once"
    assert torch.all(hits == 1), "every output written by exactly one warp"
    tot = parts.sum(dim=1)
    return out.reshape(b_, t, fc), tot[:, 0], tot[:, 1]


# (B, T, F, C, grid): ragged T and F, fewer blocks than groups at each C
@pytest.mark.parametrize("b,t,f,c,grid", [(2, 11, 20, 32, 3), (1, 17, 16, 64, 2),
                                          (2, 8, 33, 96, 5), (2, 25, 17, 32, 4)])
def test_conv3x3_int8_block_model_matches_plain(b, t, f, c, grid):
    rng = np.random.default_rng(t + f + c)

    def r(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale)
                                .astype(np.float32))
    x = r(b, t, f * c)
    wq, s_w = quantize_conv_weights_int8(r(3, 3, c, c, scale=(9 * c) ** -0.5))
    pre, add = (1 + 0.1 * r(b, c), 0.1 * r(b, c)), r(b, c)
    got = emulate_conv3x3_int8(x, wq, s_w, c=c, add=add, pre=pre, grid=grid)
    ref = conv3x3_flat_int8_plain(x, wq, s_w, c=c, add=add, pre=pre,
                                  pre_silu=True, post_silu=True,
                                  want_stats=True)
    _close(got, ref, 1e-6)


def test_int8_kernel_weights_round_trip_and_twin_unchanged():
    """prepare_params gives every int8-tap resblock conv ``wq_t``, the
    [3, 3, C_out, C_in] copy the kernel reads, which swaps back to ``wq``
    exactly; ``conv3x3_taps`` hands it to the wrapper; the twin, which reads
    HWIO ``wq``, gives the same bits with and without it."""
    tcfg = dict2namespace({
        "module": "fnet",
        "kwargs": {"hidden_size": 32, "num_hidden_layers": 1,
                   "intermediate_size": 64, "hidden_act": "gelu_new",
                   "hidden_dropout_prob": 0.1, "initializer_range": 0.02,
                   "layer_norm_eps": 1e-6},
        "channels": 32, "dtype": None, "fourier_impl": "dft_matmul"})
    cfg = unet.ModelConfig(channels=2, f_size=64, ch=(32, 64, 96, 128),
                           krn=(3,) * 4, res=(1,) * 4, num_timesteps=50,
                           transformers=tcfg, tap_int8=True)
    params = unet.init_model(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    prepared = unet.prepare_params(params, cfg)
    n = 0

    def c_of(wq):
        return wq.shape[2]
    for mod in ("down_modules", "up_modules"):
        for stage in prepared[mod]["stages"]:
            for block in stage["blocks"]:
                for name in ("conv1", "conv2"):
                    conv = block[name]
                    if "wq" not in conv:
                        assert "wq_t" not in conv
                        continue
                    n += 1
                    wq, wq_t = conv["wq"], conv["wq_t"]
                    assert wq_t.dtype == torch.int8 and wq_t.is_contiguous()
                    assert torch.equal(wq_t.permute(0, 1, 3, 2), wq)
                    assert c_of(wq) <= 96
                    w, kw = conv3x3_taps(conv, cfg.dtype, True)
                    assert w is wq and kw["wq_t"] is wq_t
                    c = wq.shape[2]
                    x = torch.randn(1, 8, 16 * c,
                                    generator=torch.Generator().manual_seed(n))
                    a = conv3x3_flat(x, wq, c=c, w_scale=kw["w_scale"],
                                     want_stats=True, post_silu=True)
                    b = conv3x3_flat(x, wq, c=c, want_stats=True,
                                     post_silu=True, **kw)
                    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert n == 2 * 2 * 3  # conv1, conv2 of the 32-, 64-, 96-wide blocks
