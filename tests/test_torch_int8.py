"""The int8-tap mode of the port's conv3x3_flat against the JAX package's
``mxu_int8`` Pallas kernel (interpret mode), with the twin's quantisation
group set to the TPU kernel's: time rows [t0 - 2, t0 + tile_t + 2), all F,
all C of one sample, i.e. ``q_tile=(tile_t, None), q_halo=(2, 0)``.

A trap met here: torch evaluates ``127.0 / tensor`` as
``reciprocal(tensor) · 127`` and ``tensor / 127.0`` as a multiplication by the
rounded reciprocal, which moves values that sit exactly on a quantisation tie
(every v = amax / 2 does) to the other integer; the twin divides tensor by
tensor. With that, every quantised integer agrees with the JAX kernel. The
full-prologue case is still held to an SNR (50 dB; both sit near 35 dB against
the fp32 conv) and not bit-tight, because JAX's and torch's silu may differ by
an fp32 ulp, which after the bf16 rounding can flip an integer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.models.unet import _resblock_init
from ddim_audio_tpu.ops.flat_resblock import resblock_flat as jax_resblock_flat
from ddim_audio_tpu.ops.pallas.conv_flat import conv3x3_flat as jax_conv3x3
from ddim_audio_tpu.ops.pallas.conv_flat import flat_period, pack_conv_weights_int8
from ddim_audio_tpu_torch.ops import launch_counts, twin_route
from ddim_audio_tpu_torch.ops.conv_flat import (
    INT8_KERNEL_HALO,
    INT8_KERNEL_TILE,
    conv3x3_flat,
    conv3x3_flat_int8,
    conv3x3_flat_int8_plain,
    conv3x3_flat_plain,
    quantize_conv_weights_int8,
)
from ddim_audio_tpu_torch.ops.flat_resblock import resblock_flat
from ddim_audio_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

SHAPES = [(32, 8), (96, 4)]  # (C, F): the TPU kernel's 9-tap and slim formats
TILE_T = 4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def snr_db(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10((ref ** 2).mean() / max(((out - ref) ** 2).mean(), 1e-300))


def _inputs(c, f, B=2, T=16):
    rng = np.random.default_rng(c)
    return dict(
        x=rng.standard_normal((B, T, f * c)).astype(np.float32),
        res=rng.standard_normal((B, T, f * c)).astype(np.float32),
        w=(rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32),
        scale=(1 + 0.1 * rng.standard_normal((B, c))).astype(np.float32),
        shift=(0.1 * rng.standard_normal((B, c))).astype(np.float32),
        add=rng.standard_normal((B, c)).astype(np.float32))


@pytest.mark.parametrize("c,f", SHAPES)
def test_quantized_weights_equal_jax_pack(c, f):
    """s_w equals the first period of pack_conv_weights_int8's scales, and wq
    its tap blocks un-packed (both TPU formats keep the in-row taps of
    output column fo = 1 at rows df·C + ci of block dt)."""
    w = _inputs(c, f)["w"]
    w2q, wsc = pack_conv_weights_int8(jnp.asarray(w))
    wq, s_w = quantize_conv_weights_int8(_t(w))
    assert wq.dtype == torch.int8 and wq.shape == (3, 3, c, c)
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(wsc)[:c])
    p = flat_period(c)
    w2q = np.asarray(w2q)
    nine = w2q.shape[0] == 9 * p
    for dt in range(3):
        base = (dt * 3 + 1) * p if nine else dt * p
        block = w2q[base:base + 3 * c, c:2 * c].reshape(3, c, c)
        np.testing.assert_array_equal(wq[dt].numpy(), block)
    deq = wq.float() * s_w
    assert float((deq - _t(w)).abs().max()) <= float(s_w.max()) / 2 + 1e-7


@pytest.mark.parametrize("c,f", SHAPES)
def test_int8_twin_matches_jax_kernel_bit_tight(c, f):
    """Residual, per-sample add, post-SiLU and statistics on; no prologue
    affine or SiLU: every quantised integer agrees, so the outputs differ by
    float rounding only (atol 1e-5 of max|out|)."""
    d = _inputs(c, f)
    w2q, wsc = pack_conv_weights_int8(jnp.asarray(d["w"]))
    with pltpu.force_tpu_interpret_mode():
        ref, r1, r2 = jax_conv3x3(
            jnp.asarray(d["x"]), w2q, c=c, tile_t=TILE_T,
            residual=jnp.asarray(d["res"]), add=jnp.tile(d["add"], (1, f)),
            post_silu=True, want_stats=True, mxu_int8=True, w_scale=wsc)
    wq, s_w = quantize_conv_weights_int8(_t(d["w"]))
    before = launch_counts()
    with twin_route(int8_group=((TILE_T, None), (2, 0))):
        out, s1, s2 = conv3x3_flat(
            _t(d["x"]), wq, c=c, residual=_t(d["res"]), add=_t(d["add"]),
            post_silu=True, want_stats=True, w_scale=s_w)
    assert launch_counts() == before  # CPU tensors never count a launch
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    fold = lambda s: np.asarray(s).reshape(s.shape[0], -1, c).sum(1)  # noqa: E731
    np.testing.assert_allclose(s1.numpy(), fold(r1), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s2.numpy(), fold(r2), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("c,f", SHAPES)
def test_int8_twin_matches_jax_kernel_full_prologue(c, f):
    d = _inputs(c, f)
    w2q, wsc = pack_conv_weights_int8(jnp.asarray(d["w"]))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_conv3x3(
            jnp.asarray(d["x"]), w2q, c=c, tile_t=TILE_T,
            residual=jnp.asarray(d["res"]),
            pre=(jnp.tile(d["scale"], (1, f)), jnp.tile(d["shift"], (1, f))),
            pre_silu=True, add=jnp.tile(d["add"], (1, f)), post_silu=True,
            mxu_int8=True, w_scale=wsc)
    wq, s_w = quantize_conv_weights_int8(_t(d["w"]))
    kw = dict(c=c, residual=_t(d["res"]), pre=(_t(d["scale"]), _t(d["shift"])),
              pre_silu=True, add=_t(d["add"]), post_silu=True)
    out = conv3x3_flat_int8_plain(_t(d["x"]), wq, s_w, q_tile=(TILE_T, None),
                                  q_halo=(2, 0), **kw)
    assert snr_db(out.numpy(), ref) >= 50.0
    # and both track the float-tap conv at int8 quantisation noise
    flt = conv3x3_flat_plain(_t(d["x"]), _t(d["w"]), **kw)
    assert snr_db(out.numpy(), flt.numpy()) >= 33.0


def _brute_force(v, wq, s_w, q_tile, q_halo):
    """Per-group loop: quantise the WHOLE array with the group's scale, run
    the exact integer conv, keep the group's own outputs."""
    b, t, f, c = v.shape
    rows, cols = q_tile
    hr, hc = q_halo
    out = torch.zeros(b, t, f, c)
    wt = wq.double().permute(3, 2, 0, 1)
    for bi in range(b):
        for r0 in range(0, t, rows):
            for c0 in range(0, f, cols):
                reg = v[bi, max(r0 - hr, 0):r0 + rows + hr,
                        max(c0 - hc, 0):c0 + cols + hc]
                amax = np.float32(max(float(reg.abs().max()), 1e-30))
                inv = np.float32(127.0) / amax  # numpy: a true fp32 division
                q = torch.round(v[bi] * float(inv)).clamp(-127, 127)
                acc = torch.nn.functional.conv2d(
                    q.double().permute(2, 0, 1)[None], wt, padding=1)[0]
                s_q = float(amax * np.float32(1.0 / 127.0))
                o = acc.float() * (s_q * s_w)[:, None, None]
                out[bi, r0:r0 + rows, c0:c0 + cols] = \
                    o.permute(1, 2, 0)[r0:r0 + rows, c0:c0 + cols]
    return out


@pytest.mark.parametrize("q_tile,q_halo", [
    (INT8_KERNEL_TILE, INT8_KERNEL_HALO), ((4, 5), (2, 0)), ((3, 16), (0, 2))])
def test_int8_twin_groups_equal_a_per_group_loop(q_tile, q_halo):
    """The vectorised twin (groups as a batch dimension, ragged edges, the
    kernel's own 8×16 group with a 1-position halo among them): each output
    position uses the scale of the group that owns it."""
    rng = np.random.default_rng(9)
    B, T, F, C = 2, 13, 21, 32
    x = _t(rng.standard_normal((B, T, F * C)) * np.exp(rng.standard_normal((B, T, 1))))
    wq, s_w = quantize_conv_weights_int8(_t(rng.standard_normal((3, 3, C, C)) * 0.1))
    out = conv3x3_flat_int8_plain(x, wq, s_w, c=C, q_tile=q_tile, q_halo=q_halo)
    v = x.bfloat16().float().view(B, T, F, C)
    ref = _brute_force(v, wq, s_w, q_tile, q_halo).reshape(B, T, F * C)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)


def test_int8_wrapper_defaults_to_the_kernel_group_on_cpu():
    rng = np.random.default_rng(10)
    x = _t(rng.standard_normal((1, 16, 24 * 32)))
    wq, s_w = quantize_conv_weights_int8(_t(rng.standard_normal((3, 3, 32, 32)) * 0.1))
    out = conv3x3_flat_int8(x, wq, s_w, c=32)
    ref = conv3x3_flat_int8_plain(x, wq, s_w, c=32, q_tile=(8, 16), q_halo=(1, 1))
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    coarse = conv3x3_flat_int8_plain(x, wq, s_w, c=32, q_tile=(None, None),
                                     q_halo=(0, 0))
    assert not torch.equal(out, coarse)


def test_twin_route_nests_and_restores():
    from ddim_audio_tpu_torch.ops import _cuda

    x = torch.zeros(1)
    assert _cuda.use_twin(x) and _cuda.twin_int8_group() is None
    meta = torch.zeros(1, device="meta")  # stands for a tensor off the CPU
    assert not _cuda.use_twin(meta)
    with twin_route(int8_group=((4, None), (2, 0))):
        assert _cuda.use_twin(meta)
        with twin_route(force=False):
            assert not _cuda.use_twin(meta)
            assert _cuda.twin_int8_group() is None
        assert _cuda.twin_int8_group() == ((4, None), (2, 0))
    assert not _cuda.use_twin(meta) and _cuda.twin_int8_group() is None


def test_resblock_flat_tap_int8_matches_jax():
    rng = np.random.default_rng(2)
    B, T, F, C = 2, 16, 8, 32
    p = _resblock_init(jax.random.key(0), C, 3, jnp.float32)
    p["norm3"]["g"] = jnp.asarray(
        1.0 + 0.2 * rng.standard_normal(C).astype(np.float32))
    x = rng.standard_normal((B, T, F * C)).astype(np.float32)
    temb = rng.standard_normal((B, C)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, (r1, r2) = jax_resblock_flat(
            p, jnp.asarray(x), jnp.asarray(temb), f=F, c=C, tile_t=8,
            want_out_stats=True, tap_int8=True)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    with twin_route(int8_group=((8, None), (2, 0))):
        out, (s1, s2) = resblock_flat(pt, _t(x), _t(temb), f=F, c=C,
                                      want_out_stats=True, tap_int8=True)
    flt = resblock_flat(pt, _t(x), _t(temb), f=F, c=C)
    assert snr_db(out.numpy(), np.asarray(ref)) >= 50.0
    assert 30.0 <= snr_db(out.numpy(), flt.numpy()) < 50.0  # int8 noise is there
    fold = np.asarray(r1).reshape(B, -1, C).sum(1)
    np.testing.assert_allclose(s1.numpy(), fold, rtol=1e-2,
                               atol=1e-2 * np.abs(fold).max())


def test_resblock_flat_tap_int8_never_quantises_a_cast_weight():
    """Without prepare_params' ``wq``/``w_scale`` the resblock quantises fp32
    weights only: integers taken from a bf16 copy would differ, silently."""
    C = 32
    p = _resblock_init(jax.random.key(1), C, 3, jnp.float32)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    x, temb = torch.zeros(1, 8, 4 * C), torch.zeros(1, C)
    resblock_flat(pt, x, temb, f=4, c=C, tap_int8=True)  # fp32 weights: fine
    for name in ("conv1", "conv2"):
        pt[name]["w"] = pt[name]["w"].bfloat16()
    resblock_flat(pt, x, temb, f=4, c=C)  # float taps take any dtype
    with pytest.raises(ValueError, match="quantised from the fp32"):
        resblock_flat(pt, x, temb, f=4, c=C, tap_int8=True)


# --------------------------------------------------- on the card (gpu) ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,C", [(24, 32), (40, 64), (12, 96)])
def test_int8_kernel_matches_twin_on_gpu(cuda, dtype, F, C):
    """The CUDA int8 kernel vs its twin with the kernel's own group, every
    fusion on, ragged tile edges. The kernel fuses the prologue's multiply
    and add, which flips a few quantised integers: SNR >= 50 dB and
    statistics within 1e-4 relative."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda)

    B, T = 2, 20
    x, res = rnd(2, B, T, F * C).to(dtype)
    wq, s_w = quantize_conv_weights_int8(rnd(3, 3, C, C) * (9 * C) ** -0.5)
    kw = dict(c=C, residual=res, pre=(1 + 0.1 * rnd(B, C), 0.1 * rnd(B, C)),
              pre_silu=True, add=rnd(B, C), post_silu=True, want_stats=True)
    before = launch_counts()["conv3x3_flat_int8"]
    out, s1, s2 = conv3x3_flat_int8(x, wq, s_w, **kw)
    assert launch_counts()["conv3x3_flat_int8"] == before + 1
    ref, r1, r2 = conv3x3_flat_int8_plain(x, wq, s_w, **kw)
    assert snr_db(out.float().cpu().numpy(), ref.float().cpu().numpy()) >= 50.0
    for a, b in ((s1, r1), (s2, r2)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="needs C in"):
        conv3x3_flat_int8(rnd(1, 4, 4 * 128).to(dtype),
                          torch.zeros(3, 3, 128, 128, dtype=torch.int8,
                                      device=cuda),
                          torch.ones(128, device=cuda), c=128)
