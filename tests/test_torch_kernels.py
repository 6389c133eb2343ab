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
    sizes that exercise the ragged tile edges (F=40, C=64 takes the bf16
    tensor-core conv3x3, F=12 the CUDA-core one); relative to max|twin|."""
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
