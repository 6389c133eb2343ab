"""The split-TF32 weight gradients of the 3×3 conv (mode 0) and of the up
conv (mode 2), on the CPU.

The CUDA kernel (``csrc/conv_dw.cu`` ``conv_dw_tf32_kernel``, the down dW's
block, mode 1, since before) runs only on the card. What surrounds its
arithmetic is checked here (its plans against ``csrc/conv_plan.cu``:
tests/test_torch_conv_redesign.py): a model of the kernel's blocks in every
mode (the plan's tiles and shares of the batch's position tiles, the x halo
and g tile staged with zeros outside and split into planes through their
slots, each halo or g row's even columns before its odd ones where that
operand is read at stride 2, the warps' taps and K sets, each k8 step's A
and B fragments read at consecutive slots from one base slot, each tile's
sum folded into the warp's total, the K sets' totals added in set order,
the shares' partials summed in order, none where there is one share)

- in fp64 against the plain twins (``conv_dw_flat_plain``,
  ``conv_up_dw_flat_plain``) within 1e-12, at ragged T and F, F = 8,
  B = 1-3, several shares and deep shapes (C 192 and 256);
- with the split-TF32 products (cvt.rna's rounding emulated) against the
  JAX package's kernels (``conv_dw_flat``, ``conv_up_dw_flat``) in Pallas
  interpret mode, unpacked through the packers' VJPs, within 2e-6 of
  max|JAX|, where single-pass TF32 lands at least ten times further off.

The module imports no JAX at top level (the JAX tests import it inside), so
its ``gpu`` tests run on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_dw_redesign.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from ddim_audio_tpu_torch.ops.flat_grad import (
    conv_dw_flat,
    conv_dw_flat_plain,
    conv_up_dw_flat,
    conv_up_dw_flat_plain,
)
from ddim_audio_tpu_torch.ops.tile_plan import (
    DW3_KSETS,
    DW_TF32_BLOCKS,
    DW_TF32_CI,
    DW_TF32_CO,
    FILL_BLOCKS,
    SMEM_PER_SM,
    VARIANT_TF32,
    conv3x3_dw_plan,
    conv_up_dw_plan,
    dw_tf32_threads,
    library_plan,
)
from tests.test_torch_downi8_dw_redesign import split_tf32

torch.set_num_threads(2)


def _cdiv(a, b):
    return -(-a // b)


def _slot(stride, r, c, w):
    """conv_dw.cu ``dw_slot``: at stride 2 a row holds its even columns,
    then its odd ones."""
    return r * w + (c % 2) * (w // 2) + c // 2 if stride == 2 else r * w + c


# mode → (taps a side, x stride, g stride, xo(k), go(k)) as conv_dw.cu's
# DwGeom, dw_xo and dw_go; the warp map as its DwTf32Map: (U taps a warp,
# kw step between them, K sets, the warp's (kh, kw0, set))
GEOM = {0: (3, 1, 1, lambda k: k - 1, lambda k: 0),
        2: (4, 1, 2, lambda k: (k + 1) // 2 - 1, lambda k: k & 1)}
PLANS = {0: conv3x3_dw_plan, 2: conv_up_dw_plan}


def warp_map(mode):
    """[(kh, kw0, K set)] of the block's warps, U and the kw step."""
    if mode == 0:
        return [(w % 3, 0, w // 3) for w in range(3 * DW3_KSETS)], 3, 1
    return [(w // 2, w % 2, 0) for w in range(8)], 2, 2


def emulate_conv_dw(mode, x, g, *, c_in, c_out, products="exact"):
    """conv_dw_tf32_kernel in mode 0 or 2. The block of share y takes
    position tiles y·per … (per = ceil(tiles / split)); a tile's x halo
    (rows t0 − 1 …, columns f0 − 1 …, zero outside) and g tile (GS·tt ×
    GS·ft from (GS·t0, GS·f0), zero outside) go into their planes through
    ``_slot``; warp (kh, kw0, set) takes taps (kh, kw0 + KWS·u) and the k8
    steps s ≡ set (mod K sets) of the tile, i = s / (ft / 8), j0 = 8·(s mod
    ft / 8); its B fragment reads g slots base + k, base = the slot of (GS·i
    + go(kh), GS·j0 + go(kw0)), its A fragments x slots base + k, base = the
    slot of (i + xo(kh) + 1, j0 + xo(kw) + 1), k = 0 … 7; each tile's sum is
    folded into the warp's total, the sets' totals added in set order. The
    block's channels (16 inputs × 32 outputs a group) are a partition of
    C_in × C_out, so the groups are taken together. products: "exact"
    (fp64, the operands as stored), "split" (x_lo·g_hi + x_hi·g_lo +
    x_hi·g_hi, exact in fp64, a tile's sum rounded to fp32 and folded by fp32
    additions) or "tf32" (x_hi·g_hi alone, single-pass TF32)."""
    kh_n, xs_, gs_, xo, go = GEOM[mode]
    b_, t, fc = x.shape
    f = fc // c_in
    plan = PLANS[mode](t, f, c_in, c_out, False, b_)
    assert plan.variant == VARIANT_TF32
    assert plan.groups == (c_in // DW_TF32_CI) * (c_out // DW_TF32_CO)
    tt, ft = plan.tile_t, plan.tile_f
    assert ft == (16 if f >= 16 else 8) and tt * ft <= (128 if mode == 0
                                                        else 64)
    assert DW_TF32_BLOCKS * (plan.smem + 1024) <= SMEM_PER_SM
    tiles_f = _cdiv(f, ft)
    per_sample = _cdiv(t, tt) * tiles_f
    assert plan.tiles == b_ * per_sample
    per = _cdiv(plan.tiles, plan.split)
    assert _cdiv(plan.tiles, per) == plan.split, "no share is empty"
    assert plan.groups * plan.split <= FILL_BLOCKS or plan.split == 1
    hr, hw = tt + 2, ft + 2                  # the x halo at stride 1
    gr_, gw = gs_ * tt, gs_ * ft             # the g tile
    xs = x.view(b_, t, f, c_in)
    gs = g.view(b_, gs_ * t, gs_ * f, c_out)
    if products == "exact":
        srcs = {"x": (xs.double(),), "g": (gs.double(),)}
        terms = [(0, 0)]
    else:
        srcs = {"x": tuple(v.double() for v in split_tf32(xs)),
                "g": tuple(v.double() for v in split_tf32(gs))}
        terms = [(0, 0)] if products == "tf32" else [(1, 0), (0, 1), (0, 0)]
    r, c = np.divmod(np.arange(hr * hw), hw)
    xslot = torch.from_numpy(_slot(1, r, c, hw))
    r, c = np.divmod(np.arange(gr_ * gw), gw)
    gslot = torch.from_numpy(_slot(gs_, r, c, gw))
    for sl, n in ((xslot, hr * hw), (gslot, gr_ * gw)):
        assert sorted(sl.tolist()) == list(range(n)), "slots are a permutation"
    warps, u_n, kws = warp_map(mode)
    assert len(warps) * 32 == dw_tf32_threads(mode)
    assert sorted((kh, kw0 + kws * u, s) for kh, kw0, s in warps
                  for u in range(u_n)) == sorted(
        (kh, kw, s) for kh in range(kh_n) for kw in range(kh_n)
        for s in range(DW3_KSETS if mode == 0 else 1)), "each tap once a set"
    fsteps = ft // 8
    steps = tt * fsteps
    k8 = torch.arange(8)
    # each warp's fragment slots over its steps: B [n], A [u, n]
    frag = []
    for kh, kw0, kset in warps:
        bs, as_ = [], [[] for _ in range(u_n)]
        for s in range(kset, steps, DW3_KSETS if mode == 0 else 1):
            i, j0 = s // fsteps, 8 * (s % fsteps)
            bs.append(_slot(gs_, gs_ * i + go(kh), gs_ * j0 + go(kw0), gw)
                      + k8)
            for u in range(u_n):
                kw = kw0 + kws * u
                as_[u].append(_slot(1, i + xo(kh) + 1, j0 + xo(kw) + 1, hw)
                              + k8)
        frag.append((kh, kw0, kset, torch.cat(bs),
                     [torch.cat(a) for a in as_]))
    part = torch.zeros((plan.split, kh_n, kh_n, c_in, c_out),
                       dtype=torch.float64)
    for share in range(plan.split):
        tot = {}  # (tap, set) → the warp's total
        for tile in range(share * per, min((share + 1) * per, plan.tiles)):
            b, rr = divmod(tile, per_sample)
            t0, f0 = (rr // tiles_f) * tt, (rr % tiles_f) * ft
            xplane, gplane = [], []
            for v in srcs["x"]:
                raw = torch.zeros((hr, hw, c_in), dtype=torch.float64)
                ts = slice(max(t0 - 1, 0), min(t0 - 1 + hr, t))
                fs = slice(max(f0 - 1, 0), min(f0 - 1 + hw, f))
                raw[ts.start - t0 + 1:ts.stop - t0 + 1,
                    fs.start - f0 + 1:fs.stop - f0 + 1] = v[b, ts, fs]
                plane = torch.empty((hr * hw, c_in), dtype=torch.float64)
                plane[xslot] = raw.reshape(-1, c_in)
                xplane.append(plane)
            for v in srcs["g"]:
                raw = torch.zeros((gr_, gw, c_out), dtype=torch.float64)
                tg = slice(gs_ * t0, min(gs_ * t0 + gr_, gs_ * t))
                fg = slice(gs_ * f0, min(gs_ * f0 + gw, gs_ * f))
                raw[:tg.stop - tg.start, :fg.stop - fg.start] = v[b, tg, fg]
                plane = torch.empty((gr_ * gw, c_out), dtype=torch.float64)
                plane[gslot] = raw.reshape(-1, c_out)
                gplane.append(plane)
            for kh, kw0, kset, bsl, asl in frag:
                for u in range(u_n):
                    key = (kh, kw0 + kws * u, kset)
                    tile_sum = sum(xplane[xi][asl[u]].T @ gplane[gi][bsl]
                                   for xi, gi in terms)
                    if products == "exact":
                        tot[key] = tot.get(key, 0) + tile_sum
                    else:  # the kernel's fold: fp32 additions
                        tot[key] = (tot.get(key, torch.zeros(
                            (c_in, c_out))).float() + tile_sum.float())
        for kh in range(kh_n):
            for kw in range(kh_n):
                sets = [tot.get((kh, kw, s), torch.zeros((c_in, c_out)))
                        for s in range(DW3_KSETS if mode == 0 else 1)]
                acc = sets[0]
                for v in sets[1:]:  # set 0 adds the others in set order
                    acc = (acc + v if products == "exact"
                           else acc.float() + v.float())
                part[share, kh, kw] = acc.double()
    if products == "exact":
        return part.sum(dim=0)
    out = part.float()
    return out[0] if plan.split == 1 else out.sum(dim=0)


def _close(got, ref, tol):
    assert got.shape == ref.shape
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    assert err <= tol, err


# (mode, B, T, F, C_in, C_out): mode 0 at one tile, several shares (T 40:
# five tile rows of 8), ragged T and F (24 × 20: tiles half empty), F = 8
# (tiles of 16 × 8), B = 3, deep 192 and 256 channels; mode 2 (x's T, F;
# g at 2T × 2F) with 64→32-style and ragged geometries, F = 8 (tiles of
# 4 × 8), B = 2-3, deep 256→192 and 192→128
DW_CASES = [
    (0, 1, 8, 16, 32, 32), (0, 1, 40, 32, 32, 32), (0, 2, 21, 20, 32, 32),
    (0, 3, 10, 8, 64, 64), (0, 1, 12, 24, 96, 96), (0, 1, 8, 16, 192, 192),
    (0, 2, 9, 8, 256, 256),
    (2, 1, 8, 16, 64, 32), (2, 2, 7, 20, 32, 64), (2, 3, 6, 8, 96, 64),
    (2, 1, 10, 36, 64, 32), (2, 1, 8, 8, 256, 192), (2, 1, 4, 16, 192, 128)]


@pytest.mark.parametrize("mode,b,t,f,c_in,c_out", DW_CASES)
def test_dw_block_model_matches_plain(mode, b, t, f, c_in, c_out):
    rng = np.random.default_rng(t * f + c_in + 7 * mode)

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s))
    gsc = 2 if mode == 2 else 1
    x, g = r(b, t, f * c_in), r(b, gsc * t, gsc * f * c_out)
    got = emulate_conv_dw(mode, x, g, c_in=c_in, c_out=c_out)
    if mode == 0:
        ref = conv_dw_flat_plain(x, g, c=c_in)
    else:
        ref = conv_up_dw_flat_plain(x, g, c_in=c_in, c_out=c_out)
    _close(got, ref, 1e-12)


def test_dw_models_cover_several_shares_and_the_single_share():
    """The cases above walk blocks of several shares (so the partials' sum
    runs) and of a single one (the wrapper's part[0])."""
    splits = {PLANS[m](t, f, ci, co, False, b).split
              for m, b, t, f, ci, co in DW_CASES}
    assert 1 in splits and max(splits) >= 8


@pytest.mark.parametrize("mode", [0, 2])
def test_split_tf32_dw_model_matches_jax_kernel_in_fp32(mode):
    """The block model with the split-TF32 products against the JAX
    package's dW kernel (f32, Pallas interpret mode, unpacked through the
    packer's VJP as ``ddim_audio_tpu/ops/flat_grad.py`` does) at a tiny
    shape: within 2e-6 of max|JAX| (the fp64 model reads about 1e-7);
    single-pass TF32 (hi·hi) lands at least ten times further off. The
    tensor cores' own accumulation order is not modelled (the card's check:
    chip_smoke.py, at most 1e-4 relative)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ddim_audio_tpu.ops import flat_grad as jfg
    from ddim_audio_tpu.ops.pallas.conv_flat import _pack9
    from ddim_audio_tpu.ops.pallas.conv_strided import pack_up_weights12

    rng = np.random.default_rng(13 + mode)
    if mode == 0:
        b, t, f, c_in, c_out = 2, 16, 16, 32, 32
        g_shape = (b, t, f * c_out)
    else:
        b, t, f, c_in, c_out = 2, 8, 8, 64, 32
        g_shape = (b, 2 * t, 2 * f * c_out)
    x = rng.standard_normal((b, t, f * c_in)).astype(np.float32)
    g = rng.standard_normal(g_shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        if mode == 0:
            packed = jfg.conv_dw_flat(jnp.asarray(x), jnp.asarray(g), c=c_in)
        else:
            packed = jfg.conv_up_dw_flat(jnp.asarray(x), jnp.asarray(g),
                                         c_in=c_in, c_out=c_out)
    packer, k = (_pack9, 3) if mode == 0 else (pack_up_weights12, 4)
    _, unpack = jax.vjp(packer, jnp.zeros((k, k, c_in, c_out), jnp.float32))
    ref = np.asarray(unpack(packed)[0], dtype=np.float64)
    scale = np.abs(ref).max()
    args = (torch.from_numpy(x), torch.from_numpy(g))
    errs = {}
    for products in ("exact", "split", "tf32"):
        got = emulate_conv_dw(mode, *args, c_in=c_in, c_out=c_out,
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


# the training shapes of one microbatch [1, 2, 1024, 256] (mode 0: T, F, C;
# mode 2: x's T, F, C_in → C_out) and the ragged ones of the models above
GPU_CASES = ([(0, 1, t, f, c, c) for t, f, c in (
    (1024, 256, 32), (512, 128, 64), (256, 64, 96), (128, 32, 128),
    (64, 16, 192), (32, 8, 256))]
    + [(2, 1, t, f, ci, co) for t, f, ci, co in (
        (512, 128, 64, 32), (256, 64, 96, 64), (128, 32, 128, 96),
        (64, 16, 192, 128), (32, 8, 256, 192))]
    + DW_CASES)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,b,t,f,c_in,c_out", GPU_CASES)
def test_fp32_dw_split_tf32_kernel_matches_twin_on_gpu(cuda, mode, b, t, f,
                                                       c_in, c_out):
    """Within 1e-4 of max|twin| (cuBLAS fp32, TF32 off), twice bit-equal,
    the split-TF32 variant, the plan of the Python model and its partials'
    count."""
    from ddim_audio_tpu_torch.ops import _cuda

    lib = _cuda.kernels()
    plan = PLANS[mode](t, f, c_in, c_out, False, b)
    query = (lib.ddim_conv3x3_dw_plan if mode == 0
             else lib.ddim_conv_up_dw_plan)
    assert library_plan(query, t, f, c_in, c_out, 0, b) == plan
    assert plan.variant == VARIANT_TF32
    assert lib.ddim_conv_dw_splits(mode, b, t, f, c_in, c_out, 0) == \
        plan.split
    assert lib.ddim_dw_tf32_threads(mode) == dw_tf32_threads(mode)
    gen = torch.Generator(device=cuda).manual_seed(t + c_in + mode)
    gsc = 2 if mode == 2 else 1
    x = torch.randn(b, t, f * c_in, generator=gen, device=cuda)
    gr = torch.randn(b, gsc * t, gsc * f * c_out, generator=gen, device=cuda)
    if mode == 0:
        def run():
            return conv_dw_flat(x, gr, c=c_in)
        ref = conv_dw_flat_plain(x, gr, c=c_in)
    else:
        def run():
            return conv_up_dw_flat(x, gr, c_in=c_in, c_out=c_out)
        ref = conv_up_dw_flat_plain(x, gr, c_in=c_in, c_out=c_out)
    got, again = run(), run()
    assert torch.equal(got, again)
    assert _rel(got, ref) <= 1e-4
