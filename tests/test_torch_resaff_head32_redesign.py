"""The persistent int8-storage resblock tail and the split-TF32 fp32 head,
on the CPU.

``csrc/residual_affine.cu`` ``residual_affine_kernel`` and
``csrc/conv_head_tail.cu`` ``conv_head_tf32_kernel`` run only on the card.
What surrounds their arithmetic is checked here (their plans against
``csrc/conv_plan.cu``: tests/test_torch_conv_redesign.py):

- ``residual_affine``: a model of the kernel's walk (``residual_affine_plan``:
  blocks on one sample and one group of 32 channels, each walking the
  sample's storage groups ``grid`` apart, every group visited once), with
  the kernel's arithmetic in numpy float32 (int8 widened through
  2^23 + q + 128 − (2^23 + 128), the fp32 operations in the kernel's order,
  no affine as scale 1 and shift −0, 127 / amax, the quantisation through
  the add of 1.5 · 2^23 and the low byte), against the twin
  ``residual_affine_flat_plain`` bit for bit (int8 outputs, scales and
  float outputs; statistics, one partial a block, within 1e-5): int8 and
  bf16 / fp32 x, ``quant_out`` on and off, statistics on and off,
  C 32-128, T and F not multiples of 8 and 16, B = 1-3, grids that make
  blocks walk several groups;
- the fp32 head: a model of the persistent walk (tiles of whole rows, the
  raw halo with its pad and zero columns, the split into hi and lo planes,
  the im2col with K padded to whole k8 steps, one statistics partial a
  block) against the twin's conv in fp64 within 1e-12, and with cvt.rna's
  split against the JAX package's ``conv_head_flat`` in Pallas interpret
  mode (single-pass TF32 at least ten times further off); the A reads of
  a warp fall in distinct banks.

The module imports no JAX at top level (the JAX test imports it inside), so
its ``gpu`` tests run on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_resaff_head32_redesign.py
-m gpu``.
"""

import numpy as np
import pytest
import torch

from ddim_audio_tpu_torch.ops.conv_flat import STORE_GROUP, quantize_store
from ddim_audio_tpu_torch.ops.flat_resblock import channel_sums
from ddim_audio_tpu_torch.ops.conv_head_tail import (
    conv_head_flat,
    conv_head_flat_plain,
)
from ddim_audio_tpu_torch.ops.residual_affine import (
    residual_affine_flat,
    residual_affine_flat_plain,
)
from ddim_audio_tpu_torch.ops.tile_plan import (
    FILL_BLOCKS,
    HEAD32_PAD,
    VARIANT_FMA,
    VARIANT_TF32,
    conv_head_plan,
    head32_halo_pitch,
    residual_affine_plan,
)
from ddim_audio_tpu_torch.tools.kernel_pair import SAMPLE_STAGES
from tests.test_torch_downi8_dw_redesign import split_tf32

torch.set_num_threads(2)
GT, GF = STORE_GROUP
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
C0 = 32


def _cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------ residual_affine --

def _widen(a: np.ndarray, dtype) -> np.ndarray:
    """The kernel's load4: int8 through the byte permute and the exact fp32
    subtraction, bf16 and fp32 as they are."""
    if dtype != torch.int8:
        return a.astype(np.float32)
    bits = (a.astype(np.int32) + 128) | 0x4B000000
    return bits.view(np.float32) - np.float32(8388736.0)


def _quant(o: np.ndarray, inv: np.ndarray) -> np.ndarray:
    """quant4v: o · inv rounded by the add of 1.5 · 2^23; the low byte."""
    t = (o * inv).astype(np.float32) + np.float32(12582912.0)
    return (t.view(np.int32) & 0xFF).astype(np.uint8).view(np.int8)


def emulate_residual_affine(x, s, affine=None, *, c, x_scales=None,
                            s_scales=None, quant_out=False, want_stats=False,
                            out_dtype=None, grid=None):
    """residual_affine_kernel's grid, block by block: block (bx, b, z) on
    sample b and channels 32·z …, walking units (storage groups) bx,
    bx + G, … of the sample. Arguments and results as the twin's; also
    returns the units each block walked and the partials [B, G, 2, C].
    x and s both float is the float tail's order: the product fused into
    the sum (one rounding, emulated in float64), and without quant_out the
    statistics of the output as stored."""
    b_n, t_len, fc = x.shape
    f_len = fc // c
    float_tail = x.dtype != torch.int8 and s.dtype != torch.int8
    odt = out_dtype or (s.dtype if s.dtype != torch.int8 else
                        x.dtype if x.dtype != torch.int8 else torch.bfloat16)
    plan = residual_affine_plan(t_len, f_len, c, KINDS[x.dtype],
                                KINDS[s.dtype], b_n)
    g = grid or plan.grid
    nt, nf = _cdiv(t_len, GT), _cdiv(f_len, GF)
    xv = x.view(b_n, t_len, f_len, c)
    sv = s.view(b_n, t_len, f_len, c)
    xn = (xv if x.dtype == torch.int8 else xv.float()).numpy()
    sn = (sv if s.dtype == torch.int8 else sv.float()).numpy()
    xs = None if x_scales is None else x_scales.numpy()
    ss = None if s_scales is None else s_scales.numpy()
    if affine is None:  # scale 1, shift −0: no bit changes
        sc = np.ones((b_n, c), np.float32)
        sh = np.full((b_n, c), -0.0, np.float32)
    else:
        sc, sh = (np.broadcast_to(np.asarray(v, np.float32), (b_n, c))
                  for v in affine)
    out = np.full((b_n, t_len, f_len, c), np.nan, np.float32)
    q = np.zeros((b_n, t_len, f_len, c), np.int8)
    scales = np.full((b_n, nt, nf, c), np.nan, np.float32)
    parts = np.zeros((b_n, g, 2, c))
    walked = {}
    for b in range(b_n):
        for z in range(c // 32):
            chs = slice(32 * z, 32 * z + 32)
            for bx in range(g):
                walked[b, z, bx] = list(range(bx, nt * nf, g))
                for u in walked[b, z, bx]:
                    gt, gf = divmod(u, nf)
                    ts = slice(gt * GT, min(t_len, gt * GT + GT))
                    fs = slice(gf * GF, min(f_len, gf * GF + GF))
                    a = _widen(xn[b, ts, fs, chs], x.dtype)
                    d = _widen(sn[b, ts, fs, chs], s.dtype)
                    if xs is not None:
                        a = a * xs[b, gt, gf, chs]
                    if ss is not None:
                        d = d * ss[b, gt, gf, chs]
                    if float_tail:  # __fmaf_rn(d, scale, a)
                        o = (a.astype(np.float64) + d.astype(np.float64)
                             * sc[b, chs]).astype(np.float32) + sh[b, chs]
                    else:
                        o = (a + d * sc[b, chs]) + sh[b, chs]
                    assert o.dtype == np.float32
                    out[b, ts, fs, chs] = o
                    w = o.astype(np.float64)
                    if float_tail and not quant_out:  # as stored
                        w = torch.from_numpy(o).to(odt).double().numpy()
                    parts[b, bx, 0, chs] += w.sum(axis=(0, 1))
                    parts[b, bx, 1, chs] += (w ** 2).sum(axis=(0, 1))
                    if quant_out:
                        amax = np.maximum(np.abs(o).max(axis=(0, 1)),
                                          np.float32(1e-30))
                        inv = np.float32(127.0) / amax
                        scales[b, gt, gf, chs] = amax * np.float32(1.0 / 127.0)
                        q[b, ts, fs, chs] = _quant(o, inv)
    if quant_out:
        res = (torch.from_numpy(q.reshape(b_n, t_len, fc)),
               torch.from_numpy(scales))
    else:
        res = (torch.from_numpy(out).to(odt).reshape(b_n, t_len, fc),)
    if want_stats:
        tot = torch.from_numpy(parts).sum(dim=1)
        res += (tot[:, 0], tot[:, 1])
    return res, walked, parts


def _resaff_operands(b, t, f, c, xk, seed, sk="int8"):
    """x (int8 with its scales, or of dtype xk), s (int8 with its scales,
    or of dtype sk), a per-sample affine."""
    rng = np.random.default_rng(seed)
    x32 = torch.from_numpy(rng.standard_normal((b, t, f, c), np.float32))
    s32 = torch.from_numpy(rng.standard_normal((b, t, f, c), np.float32)
                           * 3.0)
    if sk == "int8":
        s8, ssc = quantize_store(s32)
    else:
        s8, ssc = s32.to(sk).reshape(b, t, f * c), None
    aff = (torch.from_numpy(1 + 0.1 * rng.standard_normal((b, c),
                                                          np.float32)),
           torch.from_numpy(0.1 * rng.standard_normal((b, c), np.float32)))
    if xk == "int8":
        xin, xsc = quantize_store(x32)
    else:
        xin, xsc = x32.to(xk).reshape(b, t, f * c), None
    return xin, xsc, s8, ssc, aff


@pytest.mark.parametrize("b,t,f,c,xk,qo,stats,grid,sk", [
    (1, 41, 40, 32, "int8", True, True, None, "int8"),   # ragged T and F
    (2, 17, 24, 64, "int8", True, True, 2, "int8"),      # blocks walk 3
    (3, 9, 17, 32, "int8", True, False, 1, "int8"),      # one block a sample
    (1, 33, 16, 96, "int8", False, True, 3, "int8"),     # out bf16
    (2, 24, 40, 128, torch.bfloat16, True, True, 4, "int8"),  # stage entry
    (1, 15, 31, 64, torch.bfloat16, False, False, None, "int8"),
    (2, 16, 8, 32, torch.float32, True, True, 1, "int8"),
    (1, 7, 12, 128, torch.float32, False, True, 1, "int8"),   # out fp32
    # the float tail at s4's and s5's widths and s5's F = 8: statistics of
    # the bf16 / fp32 output as stored
    (2, 19, 8, 192, torch.bfloat16, False, True, 2, torch.bfloat16),
    (3, 32, 8, 256, torch.bfloat16, False, True, None, torch.bfloat16),
    (2, 17, 8, 256, torch.float32, False, True, 1, torch.float32),
])
def test_residual_affine_walk_bit_equal_to_plain(b, t, f, c, xk, qo, stats,
                                                 grid, sk):
    xin, xsc, s8, ssc, aff = _resaff_operands(b, t, f, c, xk, t * f + c, sk)
    for affine in (aff, None):
        kw = dict(c=c, x_scales=xsc, s_scales=ssc, quant_out=qo,
                  want_stats=stats)
        got, walked, parts = emulate_residual_affine(xin, s8, affine,
                                                     grid=grid, **kw)
        ref = residual_affine_flat_plain(xin, s8, affine, **kw)
        ref = ref if isinstance(ref, tuple) else (ref,)
        n = 2 if qo else 1
        for a, r in zip(got[:n], ref[:n]):  # q and scales, or out: the bits
            assert a.dtype == r.dtype and torch.equal(a, r)
        if qo:  # not merely equal values: the same int8 bytes
            assert torch.equal(got[0].view(torch.uint8),
                               ref[0].view(torch.uint8))
        for a, r in zip(got[n:], ref[n:]):
            assert ((a - r.double()).abs().max() / r.abs().max()).item() \
                <= 1e-5
        # the walk: each storage group once, by a block of its sample and
        # channel group; the grid of the plan unless the case caps it
        plan = residual_affine_plan(t, f, c, KINDS[xin.dtype],
                                    KINDS[s8.dtype], b)
        g = grid or plan.grid
        assert parts.shape == (b, g, 2, c)
        units = _cdiv(t, GT) * _cdiv(f, GF)
        for bb in range(b):
            for z in range(c // 32):
                seen = sorted(u for bx in range(g) for u in walked[bb, z, bx])
                assert seen == list(range(units))
        if grid is not None and units > grid:
            assert max(len(v) for v in walked.values()) >= 2
        # the wrapper on CPU tensors is the twin itself
        cpu = residual_affine_flat(xin, s8, affine, **kw)
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        assert all(torch.equal(a, r) for a, r in zip(cpu, ref))


def _three_pass_tail(x, s, scale3, shift3, c):
    """The float tail as three torch passes: addcmul (promoted to fp32,
    the product fused into the sum), add in place, the cast back."""
    b, t, fc = x.shape
    out = torch.addcmul(x.view(b, t, fc // c, c), s.view(b, t, fc // c, c),
                        scale3[:, None, None, :])
    out.add_(shift3[:, None, None, :])
    return out.to(x.dtype).view(b, t, fc)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_float_tail_plain_is_the_three_pass_route(dtype):
    """The twin's float route: the three passes' bits, and the statistics
    ``channel_sums`` takes of their stored output, bit for bit."""
    b, t, f, c = 2, 24, 8, 64
    xin, _, s, _, (scale3, shift3) = _resaff_operands(b, t, f, c, dtype, 5,
                                                      dtype)
    want = _three_pass_tail(xin, s, scale3, shift3, c)
    got, s1, s2 = residual_affine_flat_plain(
        xin, s, (scale3, shift3), c=c, want_stats=True, out_dtype=dtype)
    w1, w2 = channel_sums(want, c)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(s1, w1) and torch.equal(s2, w2)
    if dtype == torch.float32:  # the product is fused: unfused differs
        split = ((xin.view(b, t, f, c) + s.view(b, t, f, c)
                  * scale3[:, None, None, :]) + shift3[:, None, None, :])
        assert not torch.equal(split.view(b, t, f * c), got)


@pytest.mark.parametrize("c", [64, 48])
def test_resblock_tail_is_one_residual_affine_call(monkeypatch, c):
    """resblock_tail is one residual_affine_flat call at every width; on a
    CPU tensor that is the twin's three passes, bit for bit, with the
    statistics ``channel_sums`` takes of the stored output."""
    import ddim_audio_tpu_torch.ops.flat_resblock as fr

    calls = []

    def spy(*a, **kw):
        calls.append(kw["c"])
        return residual_affine_flat(*a, **kw)
    monkeypatch.setattr(fr, "residual_affine_flat", spy)
    b, t, f = 2, 16, 8
    xin, _, s, _, (scale3, shift3) = _resaff_operands(
        b, t, f, c, torch.bfloat16, 7, torch.bfloat16)
    out, s1, s2 = fr.resblock_tail(xin, s, scale3, shift3, f=f, c=c,
                                   want_stats=True)
    assert calls == [c]
    assert torch.equal(out, _three_pass_tail(xin, s, scale3, shift3, c))
    w1, w2 = fr.channel_sums(out, c)
    assert torch.equal(s1, w1) and torch.equal(s2, w2)
    assert torch.equal(fr.resblock_tail(xin, s, scale3, shift3, f=f, c=c),
                       out)


@pytest.mark.parametrize("c,error", [(64, "unsupported device"),
                                     (48, "C % 32 == 0")])
def test_resblock_tail_off_the_cpu_takes_the_kernel_or_raises(c, error):
    """Off the CPU the tail has no torch route: a width the kernel takes
    (C % 32 == 0) reaches its device check, any other width is refused by
    the shape rule (tensors on the meta device stand in for the card's)."""
    from ddim_audio_tpu_torch.ops.flat_resblock import resblock_tail

    b, t, f = 2, 16, 8
    x = torch.empty(b, t, f * c, dtype=torch.bfloat16, device="meta")
    scale3 = torch.empty(b, c, device="meta")
    with pytest.raises(ValueError, match=error):
        resblock_tail(x, x, scale3, scale3, f=f, c=c, want_stats=True)


def test_residual_affine_int8_widening_and_rounding_are_exact():
    """Every int8 value widens exactly; the add of 1.5 · 2^23 rounds every
    product in [−127.5, 127.5] to the nearest integer, ties to even, as the
    twin's torch.round does, and needs no clip: |v · (127 / amax)| stays
    under 127.5 for |v| <= amax."""
    q = np.arange(-128, 128, dtype=np.int8)
    assert np.array_equal(_widen(q, torch.int8), q.astype(np.float32))
    y = np.concatenate([np.arange(-127.5, 127.51, 0.25, dtype=np.float32),
                        np.float32([-0.0, 1e-30, -2.5, 2.5, 126.5])])
    got = _quant(y, np.ones_like(y))
    want = torch.round(torch.from_numpy(y)).clamp(-127, 127).to(torch.int8)
    inside = np.abs(y) < 127.5
    assert np.array_equal(got[inside], want.numpy()[inside])
    rng = np.random.default_rng(1)
    amax = np.abs(rng.standard_normal(10_000).astype(np.float32)) + \
        np.float32(1e-30)
    worst = np.abs((amax * (np.float32(127.0) / amax)).astype(np.float32))
    assert worst.max() < 127.5


# ---------------------------------------------------------- fp32 head ----

def _head_koff(k, c_in, hp):
    if k >= 9 * c_in:
        return None
    tap, ci = divmod(k, c_in)
    return (tap // 3) * hp + (tap % 3 - 1) * c_in + ci


def emulate_head32(x, w, bias, *, c_in, plan, products="exact"):
    """conv_head_tf32_kernel as its blocks run it. x [B, T, F·Cin] fp32 →
    (out [B, T, F·C0] fp64, partials [B, G, 2, C0], the tiles each block
    walked). products: "exact" (fp64 products of the stored values),
    "split" (the kernel's hi·hi + hi·lo + lo·hi, cvt.rna's rounding, the
    lo·lo term left out), "tf32" (hi·hi alone: single-pass TF32)."""
    b_n, t_len, fc = x.shape
    f_len = fc // c_in
    tt, g = plan.tile_t, plan.tiles
    hp = head32_halo_pitch(f_len, c_in)
    ks = _cdiv(9 * c_in, 8)
    bmat = torch.zeros(8 * ks, C0)
    bmat[:9 * c_in] = w.float().reshape(9 * c_in, C0)
    offs = [_head_koff(k, c_in, hp) for k in range(8 * ks)]
    if products == "exact":
        bh, bl = bmat.double(), torch.zeros(8 * ks, C0, dtype=torch.float64)
    else:
        bh, bl = (v.double() for v in split_tf32(bmat))
    n_tiles = _cdiv(t_len, tt)
    xd = x.float()
    out = torch.full((b_n * t_len * f_len * C0,), float("nan"),
                     dtype=torch.float64)
    parts = torch.zeros(b_n, g, 2, C0, dtype=torch.float64)
    walked = {}
    m_pad = _cdiv(tt * f_len, 16) * 16
    for b in range(b_n):
        for bx in range(g):
            walked[b, bx] = list(range(bx, n_tiles, g))
            for tile in walked[b, bx]:
                t0 = tile * tt
                raw = torch.zeros((tt + 2) * hp)  # pad and zero columns
                for r in range(tt + 2):
                    t = t0 - 1 + r
                    if 0 <= t < t_len:
                        raw[r * hp + HEAD32_PAD:
                            r * hp + HEAD32_PAD + f_len * c_in] = xd[b, t]
                if products == "exact":
                    hi, lo = raw.double(), torch.zeros_like(raw.double())
                else:
                    hi, lo = (v.double() for v in split_tf32(raw))
                valid = min(tt, t_len - t0) * f_len
                # A [positions (m16 rows, zero past the array), K columns
                # (zero past 9·Cin)] from each position's own halo element
                ah = torch.zeros(m_pad, 8 * ks, dtype=torch.float64)
                al = torch.zeros_like(ah)
                p = torch.arange(valid)
                base = (p // f_len) * hp + HEAD32_PAD + (p % f_len) * c_in
                idx = base[:, None] + torch.tensor(
                    [o for o in offs if o is not None])[None, :]
                ah[:valid, :idx.shape[1]] = hi[idx]
                al[:valid, :idx.shape[1]] = lo[idx]
                part = ah @ bh
                if products != "tf32":
                    part = part + ah @ bl + al @ bh
                o = part[:valid] + bias.double()
                parts[b, bx, 0] += o.sum(dim=0)
                parts[b, bx, 1] += (o * o).sum(dim=0)
                start = (b * t_len + t0) * f_len * C0  # one contiguous run
                out[start:start + valid * C0] = o.reshape(-1)
    return out.reshape(b_n, t_len, f_len * C0), parts, walked


def _twin64(x, w, bias, c_in):
    """The twin's conv (``conv_head_flat_plain``: F.conv2d + bias) in fp64."""
    b, t, fc = x.shape
    f = fc // c_in
    xn = x.double().view(b, t, f, c_in).permute(0, 3, 1, 2)
    out = torch.nn.functional.conv2d(
        xn, w.double().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    out = out + bias.double()
    return (out.reshape(b, t, f * C0), out.sum(dim=(1, 2)),
            (out * out).sum(dim=(1, 2)))


@pytest.mark.parametrize("b,t,f,c_in", [
    (2, 300, 256, 2),  # one row a tile, 300 tiles over 264 blocks a sample
    (1, 45, 24, 2),    # 10 rows a tile, the last 5
    (2, 11, 13, 2),    # F·Cin not a multiple of 4: element-wise halo rows
    (1, 9, 40, 1), (2, 7, 12, 3), (1, 6, 20, 4)])
def test_head32_block_model_matches_plain(b, t, f, c_in):
    rng = np.random.default_rng(t * f + c_in)
    x = torch.from_numpy(rng.standard_normal((b, t, f * c_in), np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, c_in, C0),
                                             np.float32) * 0.2)
    bias = torch.from_numpy(rng.standard_normal(C0, np.float32))
    plan = conv_head_plan(t, f, c_in, C0, False, b)
    assert plan.variant == VARIANT_TF32 and plan.tile_f == f
    assert plan.tiles == min(_cdiv(t, plan.tile_t), FILL_BLOCKS)
    out, parts, walked = emulate_head32(x, w, bias, c_in=c_in, plan=plan)
    assert parts.shape == (b, plan.tiles, 2, C0)  # one partial a block
    n_tiles = _cdiv(t, plan.tile_t)
    for bb in range(b):
        tiles = sorted(i for bx in range(plan.tiles) for i in walked[bb, bx])
        assert tiles == list(range(n_tiles))
    if (b, t) == (2, 300):
        assert plan.tile_t == 1 and max(len(v) for v in walked.values()) == 2
    ref, r1, r2 = _twin64(x, w, bias, c_in)
    assert not torch.isnan(out).any()  # every output written once
    assert (out - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()
    tot = parts.sum(dim=1)
    for got, want in ((tot[:, 0], r1), (tot[:, 1], r2)):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-12
    # the twin in fp32, as the wrapper runs it on CPU tensors
    out32 = conv_head_flat(x, w, bias, c_in=c_in, c0=C0)
    assert (out32.double() - ref).abs().max().item() <= \
        1e-5 * ref.abs().max().item()


def test_head32_reads_fall_in_distinct_banks():
    """At Cin = 2 the halo pitch is 20 words mod 32, so the A reads of a
    warp (lanes (gid, tig): row gid's column 8·s + tig (+ 4)) that span two
    halo rows never land two distinct words in one bank; fp32 rows too wide
    for the halo's four planes, and C0 != 32, take the CUDA-core kernel."""
    for f in (24, 40, 256, 600):
        hp = head32_halo_pitch(f, 2)
        assert hp % 32 == 20 and hp >= HEAD32_PAD + (f + 1) * 2
        for s in range(3):
            for hi in range(2):
                words = {}
                for lane in range(32):
                    gid, tig = divmod(lane, 4)
                    o = _head_koff(8 * s + tig + 4 * hi, 2, hp)
                    if o is not None:
                        word = HEAD32_PAD + 2 * gid + o
                        words.setdefault(word % 32, set()).add(word)
                assert all(len(v) == 1 for v in words.values()), (f, s, hi)
    assert conv_head_plan(8, 4096, 2, C0, False, 1).variant == VARIANT_FMA
    assert conv_head_plan(8, 24, 2, 16, False, 1).variant == VARIANT_FMA


def test_split_tf32_head_model_matches_jax_kernel_in_fp32():
    """The block model with the split-TF32 products against the JAX
    package's head kernel (f32, Pallas interpret mode, its own test
    geometry): within 2e-6 of max|JAX|; single-pass TF32 (hi·hi) lands at
    least ten times further off. The tensor cores' own accumulation order
    is not modelled (the card's check: chip_smoke.py, 1e-4 relative)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ddim_audio_tpu.ops.pallas.conv_head_tail import (
        conv_head_flat as jax_head,
        pack_head_weights,
    )

    b, t, f, c_in = 2, 8, 256, 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, t, f * c_in)).astype(np.float32)
    w = rng.standard_normal((3, 3, c_in, C0)).astype(np.float32) * 0.2
    bias = rng.standard_normal(C0).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_head(jnp.asarray(x), pack_head_weights(w), bias, c_in=c_in,
                       c0=C0, f=f)
    ref = np.asarray(ref, np.float64).reshape(b, t, f * C0)
    scale = np.abs(ref).max()
    plan = conv_head_plan(t, f, c_in, C0, False, b)
    errs = {}
    for products in ("exact", "split", "tf32"):
        got, _, _ = emulate_head32(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(bias), c_in=c_in,
                                   plan=plan, products=products)
        errs[products] = np.abs(got.numpy() - ref).max() / scale
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
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,f,c", [(1, 8192, 256, 32), (2, 4096, 128, 64),
                                     (2, 2048, 64, 96), (1, 1024, 32, 128),
                                     (3, 41, 40, 64), (2, 9, 17, 32)])
def test_residual_affine_kernel_bit_equal_to_twin_on_gpu(cuda, b, t, f, c):
    """Every storage stage and two ragged shapes, int8 and bf16 / fp32 x,
    quant_out on and off, with statistics: the twin's bits (statistics
    within 1e-5), twice the same bits, one partial a block."""
    from ddim_audio_tpu_torch.ops import _cuda
    from ddim_audio_tpu_torch.ops.tile_plan import library_plan

    lib = _cuda.kernels()
    for xk in ("int8", torch.bfloat16, torch.float32):
        xin, xsc, s8, ssc, aff = _resaff_operands(b, t, f, c, xk, t + c)
        xin, s8, ssc = xin.to(cuda), s8.to(cuda), ssc.to(cuda)
        xsc = None if xsc is None else xsc.to(cuda)
        aff = tuple(v.to(cuda) for v in aff)
        plan = residual_affine_plan(t, f, c, KINDS[xin.dtype], 2, b)
        assert plan == library_plan(lib.ddim_residual_affine_plan, t, f, c,
                                    KINDS[xin.dtype], 2, b)
        for qo in (True, False):
            kw = dict(c=c, x_scales=xsc, s_scales=ssc, quant_out=qo,
                      want_stats=True)
            got = residual_affine_flat(xin, s8, aff, **kw)
            again = residual_affine_flat(xin, s8, aff, **kw)
            ref = residual_affine_flat_plain(xin, s8, aff, **kw)
            assert all(torch.equal(a, r) for a, r in zip(got, again))
            n = 2 if qo else 1
            assert all(torch.equal(a, r) for a, r in zip(got[:n], ref[:n]))
            assert max(_rel(a, r) for a, r in zip(got[n:], ref[n:])) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,f,c", SAMPLE_STAGES + [(41, 40, 64),
                                                   (9, 17, 192)])
def test_float_tail_kernel_bit_equal_to_three_pass_route_on_gpu(cuda, t, f,
                                                                c, dtype):
    """The float resblock tail at B = 8 through the kernel: the bits of
    torch's three passes on the card, statistics within 1e-5 of
    ``channel_sums`` of that output, each sample's statistics and output
    the same bits at B = 1, twice the same bits."""
    from ddim_audio_tpu_torch.ops.flat_resblock import resblock_tail

    b = 8
    g = torch.Generator(device=cuda).manual_seed(t + c)
    x = torch.randn(b, t, f * c, generator=g, device=cuda).to(dtype)
    s = (3 * torch.randn(b, t, f * c, generator=g, device=cuda)).to(dtype)
    scale3 = 1 + 0.1 * torch.randn(b, c, generator=g, device=cuda)
    shift3 = 0.1 * torch.randn(b, c, generator=g, device=cuda)
    before = residual_affine_flat.launches
    got = resblock_tail(x, s, scale3, shift3, f=f, c=c, want_stats=True)
    assert residual_affine_flat.launches == before + 1
    again = resblock_tail(x, s, scale3, shift3, f=f, c=c, want_stats=True)
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    want = _three_pass_tail(x, s, scale3, shift3, c)
    assert got[0].dtype == dtype and torch.equal(got[0], want)
    del again
    assert max(_rel(a, r) for a, r in zip(got[1:],
                                          channel_sums(want, c))) <= 1e-5
    del want
    for j in (0, b - 1):
        one = resblock_tail(x[j:j + 1], s[j:j + 1], scale3[j:j + 1],
                            shift3[j:j + 1], f=f, c=c, want_stats=True)
        assert all(torch.equal(a, r[j:j + 1]) for a, r in zip(one, got))


@pytest.mark.gpu
@pytest.mark.parametrize("t,f,c_in,b", [(8192, 256, 2, 1), (8192, 256, 2, 2),
                                        (40, 24, 2, 1), (11, 13, 2, 2),
                                        (9, 40, 1, 1), (7, 12, 3, 2),
                                        (6, 20, 4, 1)])
def test_head32_split_tf32_kernel_matches_twin_on_gpu(cuda, t, f, c_in, b):
    """fp32 in split TF32: within 1e-5 of max|twin| (fp32 cuDNN, TF32 off),
    statistics within 1e-5, twice bit-equal, one partial a block."""
    from ddim_audio_tpu_torch.ops import _cuda

    g = torch.Generator(device=cuda).manual_seed(t + f)
    x = torch.randn(b, t, f * c_in, generator=g, device=cuda)
    w = 0.2 * torch.randn(3, 3, c_in, C0, generator=g, device=cuda)
    bias = torch.randn(C0, generator=g, device=cuda)
    assert _cuda.kernels().ddim_conv_head_variant(t, f, c_in, C0, 0) == \
        VARIANT_TF32
    got = conv_head_flat(x, w, bias, c_in=c_in, c0=C0, want_stats=True)
    again = conv_head_flat(x, w, bias, c_in=c_in, c0=C0, want_stats=True)
    ref = conv_head_flat_plain(x, w, bias, c_in=c_in, c0=C0, want_stats=True)
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    assert _rel(got[0], ref[0]) <= 1e-5
    assert max(_rel(got[1], ref[1]), _rel(got[2], ref[2])) <= 1e-5
