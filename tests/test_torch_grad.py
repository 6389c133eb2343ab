"""The port's differentiable flat ops (``ops/flat_grad.py``) against the JAX
package: the plain weight-gradient twins against ``jax.grad`` of the XLA
convs AND against the Pallas dW kernels in interpret mode (unpacked through
the packers' VJP, as ``ddim_audio_tpu/ops/flat_grad.py`` does), the three
autograd Functions (value, dx, dW, dadd / db; every tap looked at), the
analytic GroupNorm backward, and the trainable resblock. Inputs come from a
numpy seed and go into both packages; on the CPU the port runs its plain
twins. Tolerances are the JAX tests' own (tests/test_pallas_conv.py): atol
1e-4 on fp32 sums of a few hundred products of unit-scale numbers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.models.layers import conv_apply, conv_transpose_apply
from ddim_audio_tpu.models.unet import _resblock_init
from ddim_audio_tpu.ops import flat_grad as jfg
from ddim_audio_tpu.ops.pallas.conv_flat import _pack9
from ddim_audio_tpu.ops.pallas.conv_strided import (pack_down_weights12,
                                                    pack_up_weights12)
from ddim_audio_tpu_torch.ops import flat_grad as fg
from ddim_audio_tpu_torch.ops import launch_counts
from ddim_audio_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(grad)


def _unpacked(packer, w, packed):
    """The HWIO gradient a packed Pallas dW accumulator stands for."""
    _, unpack = jax.vjp(packer, jnp.asarray(w, jnp.float32))
    return np.asarray(unpack(packed)[0])


def _every_tap(got, ref, atol, rtol=0.0):
    """Tap by tap, so a wrong boundary mask (which moves only the edge taps)
    cannot hide in a whole-array tolerance; every tap is a real signal."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    for kh in range(ref.shape[0]):
        for kw in range(ref.shape[1]):
            assert np.abs(ref[kh, kw]).max() > 1.0, (kh, kw)
            np.testing.assert_allclose(got[kh, kw], ref[kh, kw], rtol=rtol,
                                       atol=atol, err_msg=f"tap {(kh, kw)}")


@pytest.mark.parametrize("c,f", [(32, 8), (96, 4)])
def test_conv3x3_flat_t_matches_jax(c, f):
    rng = np.random.default_rng(c)
    B, T = 2, 16
    x = rng.standard_normal((B, T, f, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    temb = rng.standard_normal((B, c)).astype(np.float32)
    cot = rng.standard_normal((B, T, f, c)).astype(np.float32)

    def loss_xla(x, w, b, e):
        out = conv_apply({"w": w, "b": b}, x, padding=1) + e[:, None, None, :]
        return jnp.sum(out * jnp.asarray(cot))

    grad_xla = jax.value_and_grad(loss_xla, argnums=(0, 1, 2, 3))
    ref_v, ref_g = grad_xla(*map(jnp.asarray, (x, w, bias, temb)))
    with pltpu.force_tpu_interpret_mode():
        packed = jfg.conv_dw_flat(jnp.asarray(x.reshape(B, T, f * c)),
                                  jnp.asarray(cot.reshape(B, T, f * c)), c=c)
    pallas_dw = _unpacked(_pack9, w, packed)

    plain = fg.conv_dw_flat_plain(_t(x.reshape(B, T, f * c)),
                                  _t(cot.reshape(B, T, f * c)), c=c)
    _every_tap(plain, ref_g[1], 1e-4)
    _every_tap(plain, pallas_dw, 1e-4)

    before = launch_counts()
    bias_v, bias_g = grad_xla(*map(jnp.asarray, (x, w, bias, 0 * temb)))
    for add, ref_v, ref_add in ((bias, bias_v, bias_g[2]),
                                (temb + bias, ref_v, ref_g[3])):
        xt, wt, at = _t(x.reshape(B, T, f * c), True), _t(w, True), _t(add, True)
        out = fg.conv3x3_flat_t(xt, wt, at, c=c)
        value = (out * _t(cot.reshape(B, T, f * c))).sum()
        value.backward()
        np.testing.assert_allclose(value.item(), float(ref_v), rtol=1e-5)
        np.testing.assert_allclose(xt.grad.numpy().reshape(B, T, f, c),
                                   np.asarray(ref_g[0]), atol=1e-4)
        _every_tap(wt.grad, ref_g[1], 1e-4)
        assert at.grad.shape == add.shape  # per sample, or summed over B
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(ref_add),
                                   atol=1e-4)
    assert launch_counts() == before  # CPU tensors never count a launch


def test_conv_down_flat_t_matches_jax():
    c_in, c_out, f = 32, 64, 8
    rng = np.random.default_rng(c_in)
    B, T = 2, 8
    x = rng.standard_normal((B, T, f, c_in)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c_in, c_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    cot = rng.standard_normal((B, T // 2, (f // 2) * c_out)).astype(np.float32)

    def loss_xla(x, w, b):
        out = conv_apply({"w": w, "b": b}, x, stride=2, padding=1)
        return jnp.sum(out.reshape(B, T // 2, -1) * jnp.asarray(cot))

    ref_v, ref_g = jax.value_and_grad(loss_xla, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w, bias)))
    with pltpu.force_tpu_interpret_mode():
        packed = jfg.conv_down_dw_flat(jnp.asarray(x.reshape(B, T, f * c_in)),
                                       jnp.asarray(cot), c_in=c_in, c_out=c_out)
    pallas_dw = _unpacked(pack_down_weights12, w, packed)

    plain = fg.conv_down_dw_flat_plain(_t(x.reshape(B, T, f * c_in)), _t(cot),
                                       c_in=c_in, c_out=c_out)
    _every_tap(plain, ref_g[1], 1e-3, 1e-4)
    _every_tap(plain, pallas_dw, 1e-3, 1e-4)

    xt, wt, bt = _t(x.reshape(B, T, f * c_in), True), _t(w, True), _t(bias, True)
    out = fg.conv_down_flat_t(xt, wt, bt, c_in=c_in, c_out=c_out)
    value = (out * _t(cot)).sum()
    value.backward()
    np.testing.assert_allclose(value.item(), float(ref_v), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().reshape(B, T, f, c_in),
                               np.asarray(ref_g[0]), atol=1e-4)
    _every_tap(wt.grad, ref_g[1], 1e-3, 1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(ref_g[2]),
                               rtol=1e-4, atol=1e-3)


def test_conv_up_flat_t_matches_jax():
    c_in, c_out, f_in = 64, 32, 4
    rng = np.random.default_rng(c_in)
    B, T = 2, 4
    x = rng.standard_normal((B, T, f_in, c_in)).astype(np.float32)
    w = (rng.standard_normal((4, 4, c_in, c_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    cot = rng.standard_normal((B, 2 * T, 2 * f_in * c_out)).astype(np.float32)

    def loss_xla(x, w, b):
        out = conv_transpose_apply({"w": w, "b": b}, x, stride=2, padding=1)
        return jnp.sum(out.reshape(B, 2 * T, -1) * jnp.asarray(cot))

    ref_v, ref_g = jax.value_and_grad(loss_xla, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w, bias)))
    with pltpu.force_tpu_interpret_mode():
        packed = jfg.conv_up_dw_flat(jnp.asarray(x.reshape(B, T, f_in * c_in)),
                                     jnp.asarray(cot), c_in=c_in, c_out=c_out)
    pallas_dw = _unpacked(pack_up_weights12, w, packed)

    plain = fg.conv_up_dw_flat_plain(_t(x.reshape(B, T, f_in * c_in)), _t(cot),
                                     c_in=c_in, c_out=c_out)
    _every_tap(plain, ref_g[1], 1e-3, 1e-4)
    _every_tap(plain, pallas_dw, 1e-3, 1e-4)

    xt, wt, bt = (_t(x.reshape(B, T, f_in * c_in), True), _t(w, True),
                  _t(bias, True))
    out = fg.conv_up_flat_t(xt, wt, bt, c_in=c_in, c_out=c_out)
    value = (out * _t(cot)).sum()
    value.backward()
    np.testing.assert_allclose(value.item(), float(ref_v), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().reshape(B, T, f_in, c_in),
                               np.asarray(ref_g[0]), atol=1e-4)
    _every_tap(wt.grad, ref_g[1], 1e-3, 1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(ref_g[2]),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("has_beta", [True, False])
def test_gn_flat_forward_and_analytic_backward(has_beta):
    rng = np.random.default_rng(2)
    B, T, F, C = 2, 16, 4, 32
    x = (1.5 * rng.standard_normal((B, T, F * C)) + 0.3).astype(np.float32)
    cot = rng.standard_normal((B, T, F * C)).astype(np.float32)
    p = {"g": (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)}
    if has_beta:
        p["b"] = rng.standard_normal(C).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jfg.gn_flat(p, x, f=F, c=C) * jnp.asarray(cot))

    ref_v, (ref_p, ref_x) = jax.value_and_grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    pt = {k: _t(v, True) for k, v in p.items()}
    xt = _t(x, True)
    value = (fg.gn_flat(pt, xt, f=F, c=C) * _t(cot)).sum()
    value.backward()
    # GroupNorm outputs are O(1); sums over 2,048 positions per channel
    np.testing.assert_allclose(value.item(), float(ref_v), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), atol=1e-5)
    for k in p:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(ref_p[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_resblock_flat_train_matches_jax_interpret():
    """Value and every gradient of the trainable resblock against the JAX
    package's, whose convs run as Pallas kernels in interpret mode."""
    rng = np.random.default_rng(5)
    B, T, F, C = 2, 16, 8, 32
    p = _resblock_init(jax.random.key(0), C, 3, jnp.float32)
    p["norm3"]["g"] = jnp.asarray(
        1.0 + 0.2 * rng.standard_normal(C).astype(np.float32))
    x = rng.standard_normal((B, T, F * C)).astype(np.float32)
    temb = rng.standard_normal((B, C)).astype(np.float32)
    cot = rng.standard_normal((B, T, F * C)).astype(np.float32)

    def loss(p, xf, temb):
        out = jfg.resblock_flat_train(p, xf, temb, f=F, c=C)
        return jnp.sum(out * jnp.asarray(cot))

    with pltpu.force_tpu_interpret_mode():
        ref_v, ref_g = jax.value_and_grad(loss, argnums=(0, 1, 2))(
            p, jnp.asarray(x), jnp.asarray(temb))

    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    leaves = [v for block in pt.values() for v in block.values()]
    for v in leaves:
        v.requires_grad_(True)
    xt, et = _t(x, True), _t(temb, True)
    value = (fg.resblock_flat_train(pt, xt, et, f=F, c=C) * _t(cot)).sum()
    value.backward()
    np.testing.assert_allclose(value.item(), float(ref_v), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_g[1]), atol=1e-4)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ref_g[2]), atol=1e-4)
    for name, block in pt.items():
        for k, v in block.items():
            np.testing.assert_allclose(
                v.grad.numpy(), np.asarray(ref_g[0][name][k]), rtol=1e-4,
                atol=1e-4, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("op", ["conv3x3", "conv3x3_per_sample", "down", "up",
                                "gn", "gn_no_beta"])
def test_functions_pass_gradcheck_in_fp64(op):
    """torch.autograd.gradcheck (fp64 finite differences) on the Functions:
    the twins accumulate in fp64 for fp64 operands."""
    gen = torch.Generator().manual_seed(0)
    B, T, F, ci, co = 2, 4, 4, 8, 16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    x = rnd(B, T, F * ci)
    if op.startswith("conv3x3"):
        add = rnd(B, ci) if op.endswith("per_sample") else rnd(ci)
        fn, args = (lambda a, b, c: fg.conv3x3_flat_t(a, b, c, c=ci)), \
            (x, rnd(3, 3, ci, ci), add)
    elif op == "down":
        fn, args = (lambda a, b, c: fg.conv_down_flat_t(
            a, b, c, c_in=ci, c_out=co)), (x, rnd(4, 4, ci, co), rnd(co))
    elif op == "up":
        fn, args = (lambda a, b, c: fg.conv_up_flat_t(
            a, b, c, c_in=ci, c_out=co)), (x, rnd(4, 4, ci, co), rnd(co))
    elif op == "gn":
        fn, args = (lambda g, b, a: fg.gn_flat({"g": g, "b": b}, a, f=F,
                                               c=ci)), (rnd(ci), rnd(ci), x)
    else:
        fn, args = (lambda g, a: fg.gn_flat({"g": g}, a, f=F, c=ci)), \
            (rnd(ci), x)
    assert torch.autograd.gradcheck(fn, args)
