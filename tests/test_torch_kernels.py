"""The port's kernel modules against the JAX package's Pallas kernels.

Inputs and weights come from a numpy seed and go into both packages; the JAX
kernels run in Pallas interpret mode (as tests/test_pallas_conv.py runs
them), the port's wrappers run their plain PyTorch twins (CPU tensors). The
CUDA kernels themselves are held against the same twins on the card by the
``gpu``-marked tests at the end and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.models.unet import _resblock_init
from ddim_audio_tpu.ops.flat_resblock import resblock_flat as jax_resblock_flat
from ddim_audio_tpu.ops.pallas.conv_flat import conv3x3_flat as jax_conv3x3
from ddim_audio_tpu.ops.pallas.conv_flat import pack_conv_weights
from ddim_audio_tpu.ops.pallas.conv_strided import (
    conv_down_flat as jax_conv_down,
    conv_up_flat as jax_conv_up,
    pack_down_weights,
    pack_up_weights,
)
from ddim_audio_tpu_torch.ops import launch_counts
from ddim_audio_tpu_torch.ops.conv_flat import conv3x3_flat, conv3x3_flat_plain
from ddim_audio_tpu_torch.ops.conv_strided import (
    conv_down_flat,
    conv_down_flat_plain,
    conv_up_flat,
    conv_up_flat_plain,
)
from ddim_audio_tpu_torch.ops.flat_resblock import resblock_flat
from ddim_audio_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

# audio.yml stage transitions at scaled-down f (tests/test_pallas_conv.py)
TRANSITIONS = [(32, 64, 8), (64, 96, 16), (96, 128, 8), (128, 192, 8),
               (192, 256, 4)]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _fold(stats_lanes, c):
    """JAX per-lane sums [B, F·C] (or period-folded [B, P]) → [B, C]."""
    s = np.asarray(stats_lanes)
    return s.reshape(s.shape[0], -1, c).sum(axis=1)


# Every fusion of the resblock convs and the padded head/tail at once:
# residual, GroupNorm prologue + SiLU, per-sample add + SiLU, stats.
@pytest.mark.parametrize("c,f", [(32, 8), (96, 4)])
def test_conv3x3_twin_matches_jax_kernel(c, f):
    rng = np.random.default_rng(c)
    B, T = 2, 16
    x = rng.standard_normal((B, T, f * c)).astype(np.float32)
    res = rng.standard_normal((B, T, f * c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal((B, c))).astype(np.float32)
    shift = (0.1 * rng.standard_normal((B, c))).astype(np.float32)
    add = rng.standard_normal((B, c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, r1, r2 = jax_conv3x3(
            jnp.asarray(x), pack_conv_weights(jnp.asarray(w)), c=c, tile_t=8,
            residual=jnp.asarray(res),
            pre=(jnp.tile(scale, (1, f)), jnp.tile(shift, (1, f))),
            pre_silu=True, add=jnp.tile(add, (1, f)), post_silu=True,
            want_stats=True)
    before = launch_counts()
    out, s1, s2 = conv3x3_flat(
        _t(x), _t(w), c=c, residual=_t(res), pre=(_t(scale), _t(shift)),
        pre_silu=True, add=_t(add), post_silu=True, want_stats=True)
    assert launch_counts() == before  # CPU tensors never count a launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), _fold(r1, c), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), _fold(r2, c), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c,f", [(32, 8), (96, 4)])
def test_conv3x3_twin_bias_only_matches_jax_kernel(c, f):
    """The padded-head form: plain conv + bias, stats, no prologue."""
    rng = np.random.default_rng(c + 1)
    B, T = 1, 16
    x = rng.standard_normal((B, T, f * c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, r1, _ = jax_conv3x3(jnp.asarray(x), pack_conv_weights(jnp.asarray(w)),
                                 c=c, tile_t=8, add=jnp.tile(bias, f),
                                 want_stats=True)
    out, s1, _ = conv3x3_flat(_t(x), _t(w), c=c, add=_t(bias), want_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), _fold(r1, c), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c_in,c_out,f", TRANSITIONS)
def test_conv_down_twin_matches_jax_kernel(c_in, c_out, f):
    rng = np.random.default_rng(c_in)
    B, T = 2, 16
    x = rng.standard_normal((B, T, f * c_in)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c_in, c_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, r1, r2 = jax_conv_down(
            jnp.asarray(x), pack_down_weights(jnp.asarray(w)), bias,
            c_in=c_in, c_out=c_out, tile_t=4, want_stats=True)
    out, s1, s2 = conv_down_flat(_t(x), _t(w), _t(bias), c_in=c_in,
                                 c_out=c_out, want_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), _fold(r1, c_out), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), _fold(r2, c_out), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c_out,c_in,f", TRANSITIONS)
def test_conv_up_twin_matches_jax_kernel(c_out, c_in, f):
    """Transposed conv with the fused skip residual and stats of the sum
    (the up path runs each down transition in reverse)."""
    f_in = f // 2
    rng = np.random.default_rng(c_in)
    B, T = 2, 8
    x = rng.standard_normal((B, T, f_in * c_in)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c_in, c_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    res = rng.standard_normal((B, 2 * T, 2 * f_in * c_out)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, r1, r2 = jax_conv_up(
            jnp.asarray(x), pack_up_weights(jnp.asarray(w)), bias,
            c_in=c_in, c_out=c_out, tile_t=4, residual=jnp.asarray(res),
            want_stats=True)
    out, s1, s2 = conv_up_flat(_t(x), _t(w), _t(bias), c_in=c_in, c_out=c_out,
                               residual=_t(res), want_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), _fold(r1, c_out), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), _fold(r2, c_out), rtol=1e-5, atol=1e-4)


def test_resblock_flat_matches_jax():
    rng = np.random.default_rng(2)
    B, T, F, C = 2, 16, 8, 32
    p = _resblock_init(jax.random.key(0), C, 3, jnp.float32)
    # non-zero final norm: at init GN3 = 0 makes the block the identity,
    # which would hide conv errors
    p["norm3"]["g"] = jnp.asarray(
        1.0 + 0.2 * rng.standard_normal(C).astype(np.float32))
    x = rng.standard_normal((B, T, F * C)).astype(np.float32)
    temb = rng.standard_normal((B, C)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, (r1, r2) = jax_resblock_flat(
            p, jnp.asarray(x), jnp.asarray(temb), f=F, c=C, tile_t=8,
            want_out_stats=True)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    out, (s1, s2) = resblock_flat(pt, _t(x), _t(temb), f=F, c=C,
                                  want_out_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)
    np.testing.assert_allclose(s1.numpy(), _fold(r1, C), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s2.numpy(), _fold(r2, C), rtol=1e-5, atol=1e-3)


# --------------------------------------------------- on the card (gpu) ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("F,C", [(12, 48), (40, 64)])
def test_kernels_match_twins_on_gpu(cuda, dtype, tol, F, C):
    """Each CUDA kernel vs its plain twin on the same CUDA tensors, at odd
    sizes that exercise the ragged tile edges (C=64 takes the bf16
    tensor-core conv3x3 and up, C=48 the CUDA-core ones); relative to
    max|twin|."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda)

    def check(kern, twin, args, kw):
        counts = launch_counts()
        got = kern(*args, **kw)
        assert sum(launch_counts().values()) == sum(counts.values()) + 1
        ref = twin(*args, **kw)
        for a, b in zip(got, ref):
            err = (a.float() - b.float()).abs().max() / b.float().abs().max()
            assert err <= tol, err

    B, T = 2, 20
    x = rnd(B, T, F * C).to(dtype)
    check(conv3x3_flat, conv3x3_flat_plain,
          (x, (0.1 * rnd(3, 3, C, C)).to(dtype)),
          dict(c=C, residual=rnd(B, T, F * C).to(dtype),
               pre=(1 + 0.1 * rnd(B, C), 0.1 * rnd(B, C)), pre_silu=True,
               add=rnd(B, C), post_silu=True, want_stats=True))
    check(conv_down_flat, conv_down_flat_plain,
          (x, (0.1 * rnd(4, 4, C, 64)).to(dtype), rnd(64)),
          dict(c_in=C, c_out=64, want_stats=True))
    check(conv_up_flat, conv_up_flat_plain,
          (x, (0.1 * rnd(4, 4, C, 32)).to(dtype), rnd(32)),
          dict(c_in=C, c_out=32, residual=rnd(B, 2 * T, 2 * F * 32).to(dtype),
               want_stats=True))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,C", [(12, 48), (40, 64), (18, 96)])
def test_dw_kernels_match_twins_on_gpu(cuda, dtype, F, C):
    """The three weight-gradient kernels vs their plain twins on the same
    CUDA tensors at ragged sizes (T = 22 is no multiple of a tile's rows,
    F = 40 / 18 none of 16; C = 48 takes the CUDA-core variant in bf16 too,
    C = 64 / 96 the tensor-core one), every tap to 1e-4 of max|twin| (the
    same operand values, fp32 sums in another order), twice bit for bit,
    and through the autograd Functions against the twins' own gradients."""
    from ddim_audio_tpu_torch.ops import flat_grad as fg
    from ddim_audio_tpu_torch.ops import twin_route

    g = torch.Generator(device=cuda).manual_seed(1)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda).to(dtype)

    B, T, C2 = 2, 22, 64
    cases = [
        (fg.conv_dw_flat, fg.conv_dw_flat_plain,
         (rnd(B, T, F * C), rnd(B, T, F * C)), dict(c=C)),
        (fg.conv_down_dw_flat, fg.conv_down_dw_flat_plain,
         (rnd(B, T, F * C), rnd(B, T // 2, (F // 2) * C2)),
         dict(c_in=C, c_out=C2)),
        (fg.conv_up_dw_flat, fg.conv_up_dw_flat_plain,
         (rnd(B, T, F * C), rnd(B, 2 * T, 2 * F * C2)),
         dict(c_in=C, c_out=C2)),
    ]
    for kern, twin, args, kw in cases:
        before = kern.launches
        got, again = kern(*args, **kw), kern(*args, **kw)
        assert kern.launches == before + 2
        ref = twin(*args, **kw)
        assert got.dtype == torch.float32 and torch.equal(got, again)
        for kh in range(ref.shape[0]):
            for kw_ in range(ref.shape[1]):
                err = (got[kh, kw_] - ref[kh, kw_]).abs().max() / ref.abs().max()
                assert err <= 1e-4, (kern.__name__, kh, kw_, float(err))

    # the Functions: kernels forward and backward vs the twins' autograd
    x, w, add = rnd(B, T, F * C), 0.1 * rnd(3, 3, C, C).float(), rnd(B, C).float()
    cot = rnd(B, T, F * C)
    grads = {}
    for route in ("kernels", "twins"):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, add)]
        with twin_route(force=route == "twins"):
            out = fg.conv3x3_flat_t(*leaves, c=C)
            grads[route] = torch.autograd.grad((out.float() * cot.float()).sum(),
                                               leaves)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(grads["kernels"], grads["twins"]):
        assert a.dtype == b.dtype
        assert (a.float() - b.float()).abs().max() <= tol * b.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,C", [(40, 32), (24, 64)])
def test_int8_storage_kernels_match_twins_on_gpu(cuda, dtype, F, C):
    """The int8-storage kernels (the storage modes of conv3x3_flat,
    residual_affine_flat) and the int8 strided taps vs their twins with the
    kernels' own groups, at ragged sizes (T = 20 is no multiple of a group's
    8 rows, F = 40 / 24 none of its 16 columns): int8 outputs equal at
    >= 99.9% of positions and never more than 1 apart, scales within 1e-5,
    float outputs within 1e-4 (fp32) / 2e-2 (bf16) of max|twin|, the same
    call twice bit for bit, one launch each."""
    from ddim_audio_tpu_torch.ops.conv_flat import quantize_store
    from ddim_audio_tpu_torch.ops.conv_strided import (
        conv_down_flat_int8, conv_down_flat_int8_plain, conv_up_flat_int8,
        conv_up_flat_int8_plain, quantize_strided_weights_int8)
    from ddim_audio_tpu_torch.ops.residual_affine import (
        residual_affine_flat, residual_affine_flat_plain)

    g = torch.Generator(device=cuda).manual_seed(2)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda)

    tol = 1e-4 if dtype == torch.float32 else 2e-2
    B, T = 2, 20
    x = rnd(B, T, F * C)
    q, sc = quantize_store(x.view(B, T, F, C))
    w = (rnd(3, 3, C, C) / (3 * C ** 0.5)).to(dtype)
    fused = dict(c=C, pre=(1 + 0.1 * rnd(B, C), 0.1 * rnd(B, C)),
                 pre_silu=True, add=rnd(B, C), post_silu=True, want_stats=True)
    wq, ws = quantize_strided_weights_int8(0.1 * rnd(4, 4, C, 64))
    wu, wus = quantize_strided_weights_int8(0.1 * rnd(4, 4, C, 32))
    cases = [
        (conv3x3_flat, conv3x3_flat_plain, (x.to(dtype), w),
         dict(fused, quant_out=True)),
        (conv3x3_flat, conv3x3_flat_plain, (q, w),
         dict(fused, in_scales=sc, quant_out=True)),
        (conv3x3_flat, conv3x3_flat_plain, (x.to(dtype), w),
         dict(fused, residual=q, res_scales=sc)),
        (residual_affine_flat, residual_affine_flat_plain,
         (q, q, (rnd(B, C), rnd(B, C))),
         dict(c=C, x_scales=sc, s_scales=sc, quant_out=True, want_stats=True)),
        (residual_affine_flat, residual_affine_flat_plain,
         (x.to(dtype), q, (rnd(B, C), rnd(B, C))),
         dict(c=C, s_scales=sc, want_stats=True, out_dtype=dtype)),
        (conv_down_flat_int8, conv_down_flat_int8_plain,
         (x.to(dtype), wq, ws, rnd(64)), dict(c_in=C, c_out=64,
                                             want_stats=True)),
        (conv_up_flat_int8, conv_up_flat_int8_plain,
         (x.to(dtype), wu, wus, rnd(32)),
         dict(c_in=C, c_out=32, want_stats=True,
              residual=rnd(B, 2 * T, 2 * F * 32).to(dtype))),
    ]
    for kern, twin, args, kw in cases:
        counts = sum(launch_counts().values())
        got, again = kern(*args, **kw), kern(*args, **kw)
        assert sum(launch_counts().values()) == counts + 2
        ref = twin(*args, **kw)
        for a, b, c in zip(got, again, ref):
            assert torch.equal(a, b)
            if a.dtype == torch.int8:
                d = (a.int() - c.int()).abs()
                assert int(d.max()) <= 1
                assert float((d == 0).float().mean()) >= 0.999
            elif a.ndim == 4:  # scales
                assert float(((a - c).abs() / c).max()) <= 1e-5
            else:
                err = (a.float() - c.float()).abs().max() / c.float().abs().max()
                assert err <= tol, (kern.__name__, float(err))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("case", ["conv3x3 F8 C256", "up 256->192 f_in 8",
                                  "conv3x3 ragged C96", "up ragged 64->32"])
def test_redesigned_kernels_match_twins_on_gpu(cuda, dtype, tol, B, case):
    """The redesigned bf16 kernels at the geometries that took other paths
    before (conv3x3 at F = 8, up at f_out = 16) and at ragged T and F: the
    variant the library reports (tensor cores in bf16, split TF32 on the
    tensor cores in fp32),
    the plan the wrapper sizes its partials from, output and statistics
    against the twin, and the same call twice bit for bit."""
    from ddim_audio_tpu_torch.ops import tile_plan
    from ddim_audio_tpu_torch.ops._cuda import kernels

    g = torch.Generator(device=cuda).manual_seed(3)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda)

    bf16 = int(dtype == torch.bfloat16)
    want = tile_plan.VARIANT_MMA if bf16 else tile_plan.VARIANT_TF32
    lib = kernels()
    if case.startswith("conv3x3"):
        T, F, C = (19, 8, 256) if "F8" in case else (21, 37, 96)
        shape = (T, F, C)
        assert lib.ddim_conv3x3_variant(*shape, bf16) == want
        assert tile_plan.library_plan(lib.ddim_conv3x3_plan, *shape, bf16, B) \
            == tile_plan.conv3x3_plan(*shape, bool(bf16), B)
        kern, twin = conv3x3_flat, conv3x3_flat_plain
        args = (rnd(B, T, F * C).to(dtype),
                (rnd(3, 3, C, C) / (3 * C ** 0.5)).to(dtype))
        kw = dict(c=C, residual=rnd(B, T, F * C).to(dtype),
                  pre=(1 + 0.1 * rnd(B, C), 0.1 * rnd(B, C)), pre_silu=True,
                  add=rnd(B, C), post_silu=True, want_stats=True)
    else:
        T, F, C_in, C_out = (5, 8, 256, 192) if "256" in case else \
            (11, 21, 64, 32)
        shape = (T, F, C_in, C_out)
        assert lib.ddim_conv_up_variant(*shape, bf16) == want
        assert tile_plan.library_plan(lib.ddim_conv_up_plan, *shape, bf16, B) \
            == tile_plan.conv_up_plan(*shape, bool(bf16), B)
        kern, twin = conv_up_flat, conv_up_flat_plain
        args = (rnd(B, T, F * C_in).to(dtype),
                (rnd(4, 4, C_in, C_out) / (2 * C_in ** 0.5)).to(dtype),
                rnd(C_out))
        kw = dict(c_in=C_in, c_out=C_out, want_stats=True,
                  residual=rnd(B, 2 * T, 2 * F * C_out).to(dtype))
    before = kern.launches
    got, again = kern(*args, **kw), kern(*args, **kw)
    assert kern.launches == before + 2
    ref = twin(*args, **kw)
    for a, b, c in zip(got, again, ref):
        assert torch.equal(a, b)
        err = (a.float() - c.float()).abs().max() / c.float().abs().max()
        assert err <= (tol if a.ndim == 3 else 1e-3), (case, float(err))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("case", ["down 192->256 f_out 8", "down ragged 32->64",
                                  "down ragged 64->96", "down ragged 128->96",
                                  "int8 C32 ragged",
                                  "int8 C64 residual", "int8 C96 ragged"])
def test_down_and_int8_redesign_match_twins_on_gpu(cuda, dtype, B, case):
    """The redesigned down conv (tensor cores in bf16 at every transition,
    f_out = 8 included; in fp32 split TF32 on the tensor cores) and int8-tap
    conv3x3 (persistent
    blocks, the [3, 3, C_out, C_in] weights) at ragged T and F: the plan the
    library reports equals the Python model, the same call twice gives the
    same bits, and each agrees with its twin (down: relative error as
    above; int8 taps: 78 dB and statistics within 1e-4, chip_smoke.py's
    floors, against the twin with the kernel's own group)."""
    from ddim_audio_tpu_torch.ops import tile_plan
    from ddim_audio_tpu_torch.ops._cuda import kernels
    from ddim_audio_tpu_torch.ops.conv_flat import (
        conv3x3_flat_int8, conv3x3_flat_int8_plain, int8_weights_co_ci,
        quantize_conv_weights_int8)

    g = torch.Generator(device=cuda).manual_seed(5)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda)

    bf16 = int(dtype == torch.bfloat16)
    lib = kernels()
    if case.startswith("down"):
        shape = {"down 192->256 f_out 8": (18, 16, 192, 256),
                 "down ragged 32->64": (22, 42, 32, 64),
                 "down ragged 64->96": (14, 26, 64, 96),
                 "down ragged 128->96": (18, 34, 128, 96)}[case]
        T, F, C_in, C_out = shape
        want = tile_plan.VARIANT_MMA if bf16 else tile_plan.VARIANT_TF32
        assert lib.ddim_conv_down_variant(*shape, bf16) == want
        assert tile_plan.library_plan(lib.ddim_conv_down_plan, *shape, bf16,
                                      B) == tile_plan.conv_down_plan(
                                          *shape, bool(bf16), B)
        args = (rnd(B, T, F * C_in).to(dtype),
                (rnd(4, 4, C_in, C_out) / (4 * C_in ** 0.5)).to(dtype),
                rnd(C_out))
        kw = dict(c_in=C_in, c_out=C_out, want_stats=True)
        kern, twin = conv_down_flat, conv_down_flat_plain
    else:
        C = int(case.split()[1][1:])
        T, F = (21, 37) if "ragged" in case else (16, 32)
        assert tuple(lib.ddim_conv3x3_int8_geometry(i) for i in range(4)) == \
            (8, 16, 1, 1)
        assert tile_plan.library_plan(lib.ddim_conv3x3_int8_plan, T, F, C,
                                      bf16, B) == tile_plan.conv3x3_int8_plan(
                                          T, F, C, bool(bf16), B)
        wq, s_w = quantize_conv_weights_int8(rnd(3, 3, C, C) / (3 * C ** 0.5))
        args = (rnd(B, T, F * C).to(dtype), wq, s_w)
        kw = dict(c=C, pre=(1 + 0.1 * rnd(B, C), 0.1 * rnd(B, C)),
                  pre_silu=True, add=rnd(B, C), post_silu=True,
                  want_stats=True)
        if "residual" in case:
            kw["residual"] = rnd(B, T, F * C).to(dtype)
        kern, twin = conv3x3_flat_int8, conv3x3_flat_int8_plain
    before = kern.launches
    if kern is conv3x3_flat_int8:
        wq_t = int8_weights_co_ci(args[1])
        got, again = kern(*args, **kw), kern(*args, wq_t=wq_t, **kw)
    else:
        got, again = kern(*args, **kw), kern(*args, **kw)
    assert kern.launches == before + 2
    ref = twin(*args, **kw)
    for i, (a, b, c) in enumerate(zip(got, again, ref)):
        assert torch.equal(a, b)
        err = (a.float() - c.float()).abs().max() / c.float().abs().max()
        if kern is conv_down_flat:
            tol = 1e-3 if i else (2e-2 if bf16 else 1e-4)
            assert err <= tol, (case, i, float(err))
        elif i == 0:
            d = (a.double() - c.double()).pow(2).mean()
            snr = 10 * torch.log10(c.double().pow(2).mean() / d.clamp_min(1e-300))
            assert snr >= 78.0, (case, float(snr))
        else:
            assert err <= 1e-4, (case, i, float(err))
