"""The split-TF32 fp32 conv3x3 and up convs, on the CPU.

The CUDA kernels (``csrc/conv3x3.cu`` ``conv3x3_tf32_kernel``,
``csrc/conv_strided.cu`` ``conv_up_tf32_kernel``) run only on the card.
What surrounds their arithmetic is checked here (their tile plans against
``csrc/conv_plan.cu``: tests/test_torch_conv_redesign.py):

- models of the two kernels' blocks, walking the grid of their plans as the
  kernels do: one output-channel group a block (grid.z), the input halo of
  each 16-channel chunk copied raw into one buffer (x and, for conv3x3, the
  residual) by the ring step two ahead of the chunk's first, the chunk's
  first step running conv3x3's prologue on it (zero outside the array
  after the prologue) and splitting it once into the hi and lo planes that
  its steps read, the ring's steps (conv3x3: chunk, tap row with its three
  taps; up: chunk, two tap offsets with the four parity classes' taps, a
  warp a class and 32 input positions), a step's sum folded into the block's
  total, the chunks split over a cluster's ranks and summed in rank order,
  stores masked at ragged edges, F = 8, per-tile statistics partials; in
  fp64 against the plain twins, and with the split-TF32 products (each
  operand rounded to a 10-bit mantissa, nearest-away, hi + lo, then lo·hi +
  hi·lo + hi·hi) against the JAX package's kernels in f32 under Pallas
  interpret mode, where single-pass TF32 is shown to fall short.

The module imports no JAX at top level (the JAX tests import it inside), so
its ``gpu`` tests run on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_conv32_up32_redesign.py -m
gpu``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddim_audio_tpu_torch.ops.conv_flat import (
    _prologue,
    conv3x3_flat,
    conv3x3_flat_plain,
    per_sample,
)
from ddim_audio_tpu_torch.ops.conv_strided import (
    conv_up_flat,
    conv_up_flat_plain,
)
from ddim_audio_tpu_torch.ops.tile_plan import (
    FILL_BLOCKS,
    TF32_K,
    VARIANT_TF32,
    conv3x3_plan,
    conv_up_plan,
    library_plan,
)

torch.set_num_threads(2)


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


def _planes_and_terms(w, products):
    """The operands a step multiplies: a function from a staged fp64 or fp32
    halo chunk to its planes, and the (plane, weight) products. products:
    "exact" (fp64, the operands as they are), "split" (lo·hi + hi·lo + hi·hi,
    exact in fp64) or "tf32" (hi·hi alone, single-pass TF32)."""
    if products == "exact":
        return (lambda v: {"hi": v.double()}), [("hi", w.double())]
    wh, wl = (u.double() for u in split_tf32(w))

    def planes(v):
        hi, lo = split_tf32(v)
        return {"hi": hi.double(), "lo": lo.double()}
    if products == "tf32":
        return planes, [("hi", wh)]
    return planes, [("lo", wh), ("hi", wl), ("hi", wh)]


def _fold(acc, acc_s, exact):
    """A step's sum into the block's: fp64, or as the kernel's registers (a
    step's sum rounded to fp32, added by an fp32 addition)."""
    return acc + acc_s if exact else (acc.float() + acc_s.float()).double()


def _halo(src, b, r0, c0, rows, cols, cis):
    """Rows r0 … r0 + rows − 1, columns c0 … of src[b] (channels cis), zero
    outside the array, as the raw copy stages them."""
    _, n_r, n_c, _ = src.shape
    out = torch.zeros((rows, cols, cis.stop - cis.start), dtype=src.dtype)
    rs = slice(max(r0, 0), min(r0 + rows, n_r))
    cs = slice(max(c0, 0), min(c0 + cols, n_c))
    if rs.start < rs.stop and cs.start < cs.stop:
        out[rs.start - r0:rs.stop - r0, cs.start - c0:cs.stop - c0] = \
            src[b, rs, cs, cis]
    return out


def _walk(steps_per_chunk, chunks, kz, ksplit, issue, split, use):
    """The K loop of one block over its rank's chunks: ``issue(s)`` copies
    step s's stage (with a chunk's first step also the chunk's raw halo,
    into the one raw buffer) two steps ahead; at step s, ``split(kc)``
    turns chunk kc's raw halo into its planes when s is the chunk's first
    step, then the step issues its copy and ``use(s)`` runs its products.
    A copy is modelled as landing at once, so one that would overwrite a
    buffer still to be read shows."""
    lo, hi = kz * chunks // ksplit, (kz + 1) * chunks // ksplit
    assert hi - lo >= min(2, chunks), "two chunks a rank at least"
    s_lo, s_hi = steps_per_chunk * lo, steps_per_chunk * hi
    for s in range(s_lo, min(s_lo + 2, s_hi)):
        issue(s)
    for s in range(s_lo, s_hi):
        if s % steps_per_chunk == 0:
            split(s // steps_per_chunk)
        if s + 2 < s_hi:
            issue(s + 2)
        use(s)


def emulate_conv3x3_tf32(x, w, *, c, add=None, residual=None, pre=None,
                         pre_silu=False, post_silu=False, products="exact"):
    """conv3x3_tf32_kernel's grid. Per block (tile, b, z): output channels
    g·NB … (z = g·ksplit + kz), TT × FT positions at tile coordinates
    (p / FT, p % FT); step s = 3·kc + dt stages tap row dt × input channels
    16·kc …, the step of chunk kc's first tap row copies the chunk's raw
    halo of x and the residual (rows t0 − 1 …, columns f0 − 1 …, zero
    outside) into the one raw buffer; chunk kc's first step applies the
    prologue (``_prologue`` on the chunk: x + residual, the affine, SiLU),
    zeroes the positions outside the array and splits the chunk into the
    planes the chunk's steps read at (p / FT + dt, p % FT + df); a step's
    sum is folded into the block's; rank 0 adds the ranks' sums in rank
    order; the epilogue adds ``add``, applies SiLU, stores masked to the
    array and writes the tile's partials."""
    b_, t, fc = x.shape
    f = fc // c
    plan = conv3x3_plan(t, f, c, False, b_)
    assert plan.variant == VARIANT_TF32 and plan.split % plan.groups == 0
    ksplit = plan.split // plan.groups
    tt, ft = plan.tile_t, plan.tile_f
    nb = c // plan.groups
    exact = products == "exact"
    wide = torch.float64 if exact else torch.float32
    xs = x.to(wide).view(b_, t, f, c)
    rs = None if residual is None else residual.to(wide).view(b_, t, f, c)
    pre_b = None if pre is None else [per_sample(v, b_, c, "cpu") for v in pre]
    add_b = None if add is None else per_sample(add, b_, c, "cpu", wide)
    planes_of, terms = _planes_and_terms(w, products)
    out = torch.full((b_, t, f, c), float("nan"), dtype=torch.float64)
    hits = torch.zeros(out.shape, dtype=torch.int64)
    parts = torch.zeros((b_, plan.tiles, 2, c), dtype=torch.float64)
    p = torch.arange(tt * ft)
    pr, pc = p // ft, p % ft
    chunks, tiles_f = c // TF32_K, -(-f // ft)
    for b in range(b_):
        for tile in range(plan.tiles):
            t0, f0 = (tile // tiles_f) * tt, (tile % tiles_f) * ft
            valid = (t0 + pr < t) & (f0 + pc < f)
            hr, hc = t0 - 1 + torch.arange(tt + 2), f0 - 1 + torch.arange(ft + 2)
            inside = ((hr >= 0) & (hr < t))[:, None] & \
                ((hc >= 0) & (hc < f))[None, :]
            for z in range(plan.split):
                g, kz = divmod(z, ksplit)
                cos = slice(g * nb, (g + 1) * nb)
                buf = {}  # the raw buffer and the planes: (chunk, data)

                def issue(s, b=b, t0=t0, f0=f0, buf=buf):
                    if s % 3 == 0:
                        cis = slice(s // 3 * TF32_K, (s // 3 + 1) * TF32_K)
                        buf["raw"] = (s // 3, [
                            None if src is None else
                            _halo(src, b, t0 - 1, f0 - 1, tt + 2, ft + 2, cis)
                            for src in (xs, rs)])

                acc = [torch.zeros((tt * ft, nb), dtype=torch.float64)]

                def split(kc, b=b, buf=buf, inside=inside):
                    # the prologue and the split, once a chunk
                    cis = slice(kc * TF32_K, (kc + 1) * TF32_K)
                    chunk, (rx, rr) = buf["raw"]
                    assert chunk == kc, "the raw buffer holds this chunk"
                    shape = (1, tt + 2, (ft + 2) * TF32_K)
                    v = _prologue(
                        rx.reshape(shape), TF32_K,
                        None if rr is None else rr.reshape(shape),
                        None if pre_b is None else
                        (pre_b[0][b:b + 1, cis], pre_b[1][b:b + 1, cis]),
                        pre_silu, wide).view(tt + 2, ft + 2, TF32_K)
                    v = torch.where(inside[..., None], v, 0.0)
                    buf["planes"] = (kc, planes_of(v))

                def use(s, buf=buf, acc=acc, cos=cos):
                    kc, dt = divmod(s, 3)
                    cis = slice(kc * TF32_K, (kc + 1) * TF32_K)
                    chunk, pl = buf["planes"]
                    assert chunk == kc, "a chunk's planes outlive its steps"
                    acc_s = torch.zeros_like(acc[0])
                    for df in range(3):
                        for src, wt in terms:
                            acc_s += pl[src][pr + dt, pc + df] @ \
                                wt[dt, df][cis, cos]
                    acc[0] = _fold(acc[0], acc_s, exact)

                _walk(3, chunks, kz, ksplit, issue, split, use)
                # the cluster's rank 0 adds the ranks' sums in rank order
                total = acc[0] if kz == 0 else _fold(total, acc[0], exact)
                if kz < ksplit - 1:
                    continue
                o = total.to(wide)
                if add_b is not None:
                    o = o + add_b[b, cos]
                if post_silu:
                    o = F.silu(o)
                o = o.double()[valid]
                oi, oj = t0 + pr[valid], f0 + pc[valid]
                out[b, oi, oj, cos] = o
                hits[b, oi, oj, cos] += 1
                parts[b, tile, 0, cos] = o.sum(0)
                parts[b, tile, 1, cos] = (o * o).sum(0)
    assert torch.all(hits == 1), "every output written by exactly one block"
    tot = parts.sum(dim=1)
    return out.reshape(b_, t, fc), tot[:, 0], tot[:, 1]


def emulate_conv_up_tf32(x, w, bias, *, c_in, c_out, residual=None,
                         products="exact"):
    """conv_up_tf32_kernel's grid. Per block (tile, b, z): output channels
    32·g … (z = g·ksplit + kz), input positions (i0 + p / FT, j0 + p % FT)
    of a TT × FT tile; step s = 2·kc + h stages tap offsets ab = 2h, 2h +
    1 ((a, b) = (ab >> 1, ab & 1)) × input channels 16·kc …, the step of
    chunk kc's first offsets copies its raw halo (rows i0 − 1 …, columns
    j0 − 1 …, zero outside) into the one raw buffer, chunk kc's first step
    splits it into the planes before it issues its copy; warp w computes
    class (py, px) = ((w & 3) >> 1, w & 1) of
    input positions 32·(w >> 2) … +31, reading the planes at (p / FT + py +
    a, p % FT + px + b) and tap w[py + 2a, px + 2b]; a step's sum is folded
    into the warp's; rank 0 adds the ranks' sums in rank order; the
    epilogue adds the bias and then the residual at output (2i + py,
    2j + px), masked to the array, and writes the tile's partials."""
    b_, t, fc = x.shape
    f = fc // c_in
    plan = conv_up_plan(t, f, c_in, c_out, False, b_)
    assert plan.variant == VARIANT_TF32 and plan.split % plan.groups == 0
    ksplit = plan.split // plan.groups
    tt, ft = plan.tile_t, plan.tile_f
    assert tt * ft == 64 and plan.groups == c_out // 32
    exact = products == "exact"
    wide = torch.float64 if exact else torch.float32
    xs = x.to(wide).view(b_, t, f, c_in)
    # the twin adds the residual in fp32 (exact for fp32-valued operands)
    res = None if residual is None else \
        residual.float().to(wide).view(b_, 2 * t, 2 * f, c_out)
    planes_of, terms = _planes_and_terms(w, products)
    out = torch.full((b_, 2 * t, 2 * f, c_out), float("nan"),
                     dtype=torch.float64)
    hits = torch.zeros(out.shape, dtype=torch.int64)
    parts = torch.zeros((b_, plan.tiles, 2, c_out), dtype=torch.float64)
    chunks, tiles_f = c_in // TF32_K, -(-f // ft)
    for b in range(b_):
        for tile in range(plan.tiles):
            i0, j0 = (tile // tiles_f) * tt, (tile % tiles_f) * ft
            s1 = torch.zeros(c_out, dtype=torch.float64)
            s2 = torch.zeros(c_out, dtype=torch.float64)
            for z in range(plan.split):
                g, kz = divmod(z, ksplit)
                cos = slice(g * 32, (g + 1) * 32)
                buf = {}

                def issue(s, b=b, i0=i0, j0=j0, buf=buf):
                    if s % 2 == 0:
                        cis = slice(s // 2 * TF32_K, (s // 2 + 1) * TF32_K)
                        buf["raw"] = (s // 2, _halo(xs, b, i0 - 1, j0 - 1,
                                                    tt + 2, ft + 2, cis))

                def split(kc, buf=buf):
                    chunk, raw = buf["raw"]
                    assert chunk == kc, "the raw buffer holds this chunk"
                    buf["planes"] = (kc, planes_of(raw))

                acc = {w_: torch.zeros((32, 32), dtype=torch.float64)
                       for w_ in range(8)}

                def use(s, buf=buf, acc=acc, cos=cos):
                    kc, h = divmod(s, 2)
                    cis = slice(kc * TF32_K, (kc + 1) * TF32_K)
                    chunk, pl = buf["planes"]
                    assert chunk == kc, "a chunk's planes outlive its steps"
                    for warp in range(8):
                        py, px = (warp & 3) >> 1, warp & 1
                        q = 32 * (warp >> 2) + torch.arange(32)
                        acc_s = torch.zeros((32, 32), dtype=torch.float64)
                        for ab in (2 * h, 2 * h + 1):
                            a, bb = ab >> 1, ab & 1
                            for src, wt in terms:
                                acc_s += pl[src][q // ft + py + a,
                                                 q % ft + px + bb] @ \
                                    wt[py + 2 * a, px + 2 * bb][cis, cos]
                        acc[warp] = _fold(acc[warp], acc_s, exact)

                _walk(2, chunks, kz, ksplit, issue, split, use)
                if kz == 0:
                    total = {w_: v.clone() for w_, v in acc.items()}
                else:
                    total = {w_: _fold(total[w_], acc[w_], exact)
                             for w_ in acc}
                if kz < ksplit - 1:
                    continue
                for warp in range(8):
                    py, px = (warp & 3) >> 1, warp & 1
                    q = 32 * (warp >> 2) + torch.arange(32)
                    i, j = i0 + q // ft, j0 + q % ft
                    ok = (i < t) & (j < f)
                    oi, oj = 2 * i[ok] + py, 2 * j[ok] + px
                    o = total[warp].to(wide)[ok] + bias.to(wide)[cos]
                    if res is not None:
                        o = o + res[b, oi, oj, cos]
                    o = o.double()
                    out[b, oi, oj, cos] = o
                    hits[b, oi, oj, cos] += 1
                    s1[cos] += o.sum(0)
                    s2[cos] += (o * o).sum(0)
            parts[b, tile, 0], parts[b, tile, 1] = s1, s2
    assert torch.all(hits == 1), "every output written by exactly one warp"
    tot = parts.sum(dim=1)
    return (out.reshape(b_, 2 * t, 2 * f * c_out), tot[:, 0], tot[:, 1])


def _close(got, ref, tol):
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        assert err <= tol, err


def _r(rng, *s, scale=1.0):
    """fp32-valued numbers in fp64 (the twins round some operands to fp32)."""
    return torch.from_numpy((rng.standard_normal(s) * scale)
                            .astype(np.float32)).double()


# (B, T, F, C): C = 32 with ragged T; C = 256 at F = 8 (two warps across 64
# channels, four groups, the chunks split over eight ranks); C = 96 with a
# ragged F (three groups, split K); C = 64 at F = 12 (8-column tiles, split
# K); a sample whose grid takes the 128-position tile of two warps across
# 64 channels (MT = 2); C = 192 with its 12 chunks split over five ranks
# (2, 2, 2, 3, 3)
CONV32_CASES = [(1, 20, 16, 32), (2, 9, 8, 256), (1, 12, 20, 96),
                (1, 10, 12, 64), (1, 136, 256, 64), (1, 32, 16, 192)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,t,f,c", CONV32_CASES)
def test_conv3x3_tf32_block_model_matches_plain(b, t, f, c, fused):
    rng = np.random.default_rng(c + f + t)
    x, w = _r(rng, b, t, f * c), _r(rng, 3, 3, c, c, scale=(9 * c) ** -0.5)
    kw = dict(c=c, want_stats=True)
    if fused:
        kw.update(residual=_r(rng, b, t, f * c),
                  pre=(1 + 0.1 * _r(rng, b, c).float(),
                       0.1 * _r(rng, b, c).float()),
                  pre_silu=True, add=_r(rng, b, c), post_silu=True)
    # MT = 2 (128 positions, two warps across 64 channels) only where two
    # such blocks fit an SM and one sample's grid of them reaches
    # FILL_BLOCKS; else MT = 1 (128 or 64 positions)
    plan = conv3x3_plan(t, f, c, False, b)
    ft = 16 if f >= 16 else 8
    full = c % 64 == 0 and \
        -(-t // (128 // ft)) * -(-f // ft) * plan.groups >= FILL_BLOCKS
    assert plan.groups == c // (64 if c % 64 == 0 else 32)
    assert (plan.tile_t * plan.tile_f, plan.tile_f) == \
        (128 if full or c % 64 else 64, ft)
    assert full == (t == 136)
    assert (plan.split > plan.groups) == (c >= 64 and not full)
    if c == 192:
        assert plan.split // plan.groups == 5
    ref = conv3x3_flat_plain(x, w, **kw)
    kw.pop("want_stats")
    got = emulate_conv3x3_tf32(x, w, **kw)
    _close(got, ref, 1e-12)


# (B, T_in, F_in, C_in, C_out): 256→192 (six groups, the chunks split over
# eight ranks), 64→32 at F_in = 8 (8 × 8 tiles) with a ragged T, 96→64 with
# a ragged F, 32→64 at F_in < 8, 192→128 with its K split, 256→192 with its
# 16 chunks split over five ranks (3, 3, 3, 3, 4)
UP32_CASES = [(1, 6, 16, 256, 192), (2, 5, 8, 64, 32), (1, 9, 20, 96, 64),
              (1, 3, 7, 32, 64), (1, 8, 16, 192, 128), (1, 16, 16, 256, 192)]


@pytest.mark.parametrize("b,t,f,c_in,c_out", UP32_CASES)
def test_conv_up_tf32_block_model_matches_plain(b, t, f, c_in, c_out):
    rng = np.random.default_rng(c_in + f + t)
    x = _r(rng, b, t, f * c_in)
    w = _r(rng, 4, 4, c_in, c_out, scale=(4 * c_in) ** -0.5)
    bias, res = _r(rng, c_out), _r(rng, b, 2 * t, 2 * f * c_out)
    plan = conv_up_plan(t, f, c_in, c_out, False, b)
    assert (plan.split > plan.groups) == (c_in >= 64)
    if t == 16:
        assert plan.split // plan.groups == 5
    ref = conv_up_flat_plain(x, w, bias, c_in=c_in, c_out=c_out,
                             residual=res, want_stats=True)
    got = emulate_conv_up_tf32(x, w, bias, c_in=c_in, c_out=c_out,
                               residual=res)
    _close(got, ref, 1e-12)


def _against_jax(ref, r1, r2, run, c):
    """max|model − JAX| over max|JAX| for each products mode, and the split
    model's statistics against the JAX kernel's (folded over the lanes)."""
    ref = np.asarray(ref, dtype=np.float64)
    b = ref.shape[0]
    scale = np.abs(ref).max()
    errs = {}
    for products in ("exact", "split", "tf32"):
        out, s1, s2 = run(products)
        errs[products] = np.abs(out.numpy() - ref).max() / scale
        if products == "split" and r1 is not None:
            for got, want in zip((s1, s2), (r1, r2)):
                want = np.asarray(want).reshape(b, -1, c).sum(axis=1)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-4)
    assert errs["exact"] <= 1e-6, errs
    assert errs["split"] <= 2e-6, errs
    assert errs["tf32"] >= 10 * errs["split"], errs


@pytest.mark.parametrize("fused", [True, False])
def test_conv3x3_split_tf32_model_matches_jax_kernel_in_fp32(fused):
    """The conv3x3 block walk with the split-TF32 products against the JAX
    package's conv3x3 (f32 compute, Pallas interpret mode), with the
    residual, the prologue's affine and SiLU, add, post-SiLU and the
    statistics on, and once bare: within 2e-6 of max|JAX|; single-pass TF32
    lands at least ten times further off. The tensor cores' own
    accumulation order is not modelled (the card's check: chip_smoke.py, at
    most 1e-4 relative, 100 dB a call in the gradient phase)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ddim_audio_tpu.ops.pallas.conv_flat import (
        conv3x3_flat as jax_conv3x3,
        pack_conv_weights,
    )

    b, t, f, c = 1, 16, 16, 32
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, t, f * c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32)
    jkw, tkw = {}, {}
    if fused:
        res = rng.standard_normal((b, t, f * c)).astype(np.float32)
        scale = (1 + 0.1 * rng.standard_normal((b, c))).astype(np.float32)
        shift = (0.1 * rng.standard_normal((b, c))).astype(np.float32)
        add = rng.standard_normal((b, c)).astype(np.float32)
        jkw = dict(residual=jnp.asarray(res),
                   pre=(jnp.tile(scale, (1, f)), jnp.tile(shift, (1, f))),
                   pre_silu=True, add=jnp.tile(add, (1, f)), post_silu=True,
                   want_stats=True)
        tkw = dict(residual=torch.from_numpy(res),
                   pre=(torch.from_numpy(scale), torch.from_numpy(shift)),
                   pre_silu=True, add=torch.from_numpy(add), post_silu=True)
    with pltpu.force_tpu_interpret_mode():
        got = jax_conv3x3(jnp.asarray(x), pack_conv_weights(jnp.asarray(w)),
                          c=c, tile_t=8, compute_dtype=jnp.float32, **jkw)
    ref, r1, r2 = got if fused else (got, None, None)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _against_jax(ref, r1, r2, lambda products: emulate_conv3x3_tf32(
        xt, wt, c=c, products=products, **tkw), c)


def test_conv_up_split_tf32_model_matches_jax_kernel_in_fp32():
    """The up conv's block walk with the split-TF32 products against the JAX
    package's up kernel (f32, Pallas interpret mode) with the skip residual
    and the statistics: within 2e-6 of max|JAX|; single-pass TF32 lands at
    least ten times further off."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ddim_audio_tpu.ops.pallas.conv_strided import (
        conv_up_flat as jax_conv_up,
        pack_up_weights,
    )

    b, t, f, c_in, c_out = 1, 8, 16, 64, 32
    rng = np.random.default_rng(13)
    x = rng.standard_normal((b, t, f * c_in)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c_in, c_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    res = rng.standard_normal((b, 2 * t, 2 * f * c_out)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, r1, r2 = jax_conv_up(
            jnp.asarray(x), pack_up_weights(jnp.asarray(w)), bias,
            c_in=c_in, c_out=c_out, tile_t=4, residual=jnp.asarray(res),
            want_stats=True)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    _against_jax(ref, r1, r2, lambda products: emulate_conv_up_tf32(
        *args, c_in=c_in, c_out=c_out, residual=torch.from_numpy(res),
        products=products), c_out)


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


def _check_kernel(kern, twin, args, kw):
    """Twice bit-equal, two launches counted, within 1e-4 of max|twin|
    (cuDNN fp32, TF32 off), statistics within 1e-3."""
    before = kern.launches
    got, again = kern(*args, **kw), kern(*args, **kw)
    assert kern.launches == before + 2
    ref = twin(*args, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert _rel(got[0], ref[0]) <= 1e-4
    assert max(_rel(got[1], ref[1]), _rel(got[2], ref[2])) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,t,f,c", [
    (1, 1024, 256, 32), (1, 512, 128, 64), (1, 256, 64, 96), (1, 128, 32, 128),
    (1, 64, 16, 192), (1, 32, 8, 256), (2, 21, 37, 96), (2, 19, 8, 256)])
def test_fp32_conv3x3_split_tf32_kernel_matches_twin_on_gpu(cuda, b, t, f, c,
                                                            fused):
    """The training shapes and two ragged ones, every fusion on or bare: the
    split-TF32 variant, the plan of the Python model, the twin's result."""
    from ddim_audio_tpu_torch.ops import _cuda

    lib = _cuda.kernels()
    assert library_plan(lib.ddim_conv3x3_plan, t, f, c, 0, b) == \
        conv3x3_plan(t, f, c, False, b)
    assert lib.ddim_conv3x3_variant(t, f, c, 0) == VARIANT_TF32
    g = torch.Generator(device=cuda).manual_seed(t + c)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda) * scale
    kw = dict(c=c, want_stats=True)
    if fused:
        kw.update(residual=rnd(b, t, f * c), pre=(1 + 0.1 * rnd(b, c),
                                                  0.1 * rnd(b, c)),
                  pre_silu=True, add=rnd(b, c), post_silu=True)
    _check_kernel(conv3x3_flat, conv3x3_flat_plain,
                  (rnd(b, t, f * c), rnd(3, 3, c, c, scale=(9 * c) ** -0.5)),
                  kw)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,f,c_in,c_out", [
    (1, 512, 128, 64, 32), (1, 256, 64, 96, 64), (1, 128, 32, 128, 96),
    (1, 64, 16, 192, 128), (1, 32, 8, 256, 192), (2, 11, 21, 64, 32),
    (2, 5, 8, 256, 192)])
def test_fp32_up_split_tf32_kernel_matches_twin_on_gpu(cuda, b, t, f, c_in,
                                                       c_out):
    """The training transitions and two ragged ones, with the skip residual
    and the statistics: the split-TF32 variant, the plan of the Python
    model, the twin's result."""
    from ddim_audio_tpu_torch.ops import _cuda

    lib = _cuda.kernels()
    assert library_plan(lib.ddim_conv_up_plan, t, f, c_in, c_out, 0, b) == \
        conv_up_plan(t, f, c_in, c_out, False, b)
    assert lib.ddim_conv_up_variant(t, f, c_in, c_out, 0) == VARIANT_TF32
    g = torch.Generator(device=cuda).manual_seed(t + c_in)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda) * scale
    _check_kernel(conv_up_flat, conv_up_flat_plain,
                  (rnd(b, t, f * c_in),
                   rnd(4, 4, c_in, c_out, scale=(4 * c_in) ** -0.5),
                   rnd(c_out)),
                  dict(c_in=c_in, c_out=c_out, want_stats=True,
                       residual=rnd(b, 2 * t, 2 * f * c_out)))
