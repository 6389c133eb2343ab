"""The int8 taps of the strided transitions (``sampling.strided_int8``):
``conv_down_flat_int8`` / ``conv_up_flat_int8`` of the port against the JAX
package's ``mxu_int8`` Pallas kernels (interpret mode), with the twin's group
set to the TPU kernels' (one scale per tile of output rows, over all F and
all input channels, with 2 input rows staged on each side); the quantised
weights against the JAX packers; the transition predicate against
``strided_int8_profitable``; the wrappers' own group on the CPU."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.ops.pallas.conv_strided import (
    _pack_down,
    _pack_up,
    conv_down_flat as jax_down,
    conv_up_flat as jax_up,
    pack_down_weights_int8,
    pack_up_weights_int8,
    strided_int8_profitable,
)
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.ops import launch_counts, twin_route
from ddim_audio_tpu_torch.ops.conv_strided import (
    STRIDED_INT8_HALO,
    STRIDED_INT8_TILE,
    conv_down_flat,
    conv_down_flat_int8_plain,
    conv_up_flat,
    conv_up_flat_int8_plain,
    quantize_strided_weights_int8,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
# (C_in, C_out, T_in, F_in, TPU tile_t): the transitions that run int8 taps
# at audio.yml, at small T and F
DOWN = [(32, 64, 16, 8, 4)]
UP = [(64, 32, 8, 4, 4), (256, 192, 4, 2, 2)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _inputs(ci, co, t, f, up, seed):
    rng = np.random.default_rng(seed)
    to, fo = (2 * t, 2 * f) if up else (t // 2, f // 2)
    return dict(
        x=rng.standard_normal((B, t, f * ci)).astype(np.float32),
        w=(rng.standard_normal((4, 4, ci, co)) / np.sqrt(16 * ci))
        .astype(np.float32),
        b=rng.standard_normal(co).astype(np.float32),
        res=rng.standard_normal((B, to, fo * co)).astype(np.float32))


@pytest.mark.parametrize("up,ci,co", [(False, 32, 64), (True, 64, 32),
                                      (True, 256, 192)])
def test_quantized_weights_equal_jax_packers(up, ci, co):
    """s_w equals the first C_out of the JAX packer's per-lane scales, and
    packing the port's integers with the JAX layout gives its int8 blocks."""
    w = _inputs(ci, co, 4, 2, up, seed=ci)["w"]
    w2q, wsc = (pack_up_weights_int8 if up else pack_down_weights_int8)(
        jnp.asarray(w))
    wq, s_w = quantize_strided_weights_int8(_t(w))
    assert wq.dtype == torch.int8 and wq.shape == (4, 4, ci, co)
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(wsc)[:co])
    packed = (_pack_up if up else _pack_down)(jnp.asarray(wq.float().numpy()),
                                              False)
    np.testing.assert_array_equal(np.asarray(packed).astype(np.int8),
                                  np.asarray(w2q))


@pytest.mark.parametrize("up,ci,co,t,f,tile_t,dt", [
    (False, *DOWN[0], "fp32"), (False, *DOWN[0], "bf16"),
    (True, *UP[0], "fp32"), (True, *UP[1], "bf16")])
def test_int8_twins_match_jax_kernels(up, ci, co, t, f, tile_t, dt):
    """Every quantised integer agrees (the same amax over the same staged
    rows, a true division), the int32 sums are exact on both sides, so the
    outputs differ by the float rounding of the dequant only."""
    tdt, jdt = ((torch.float32, jnp.float32) if dt == "fp32"
                else (torch.bfloat16, jnp.bfloat16))
    d = _inputs(ci, co, t, f, up, seed=co + t)
    w2q, wsc = (pack_up_weights_int8 if up else pack_down_weights_int8)(
        jnp.asarray(d["w"]))
    xj = jnp.asarray(d["x"]).astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        if up:
            ref = jax_up(xj, w2q, jnp.asarray(d["b"]), c_in=ci, c_out=co,
                         tile_t=tile_t, residual=jnp.asarray(d["res"]).astype(jdt),
                         want_stats=True, mxu_int8=True, w_scale=wsc)
        else:
            ref = jax_down(xj, w2q, jnp.asarray(d["b"]), c_in=ci, c_out=co,
                           tile_t=tile_t, want_stats=True, mxu_int8=True,
                           w_scale=wsc)
    wq, s_w = quantize_strided_weights_int8(_t(d["w"]))
    # the TPU group: the output tile of the TPU kernel (tile_t rows down,
    # 2·tile_t rows up, all columns), 2 input rows staged on each side
    group = ((2 * tile_t if up else tile_t, None), (2, 0))
    kw = dict(c_in=ci, c_out=co, want_stats=True)
    if up:
        kw["residual"] = _t(d["res"], tdt)
    before = launch_counts()
    with twin_route(int8_group={"strided": group}):
        out, s1, s2 = (conv_up_flat if up else conv_down_flat)(
            _t(d["x"], tdt), wq, _t(d["b"]), w_scale=s_w, **kw)
    assert launch_counts() == before  # CPU tensors never count a launch
    r = np.asarray(ref[0].astype(jnp.float32))
    assert out.dtype == tdt and out.shape == r.shape
    np.testing.assert_allclose(out.float().numpy(), r, rtol=0,
                               atol=1e-5 * np.abs(r).max())
    fold = lambda s: np.asarray(s).reshape(B, -1, co).sum(1)  # noqa: E731
    np.testing.assert_allclose(s1.numpy(), fold(ref[1]), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s2.numpy(), fold(ref[2]), rtol=1e-5, atol=1e-3)


def test_transition_predicate_matches_jax():
    """int8 strided taps where the JAX package's strided_int8_profitable
    holds: down 32→64, up 64→32 and up 256→192 at audio.yml, and both
    transitions of the small parity geometry (ch 32, 64)."""
    config = load_config(os.path.join(REPO, "configs", "audio.yml"))
    cfg = dataclasses.replace(unet.ModelConfig.from_config(config),
                              strided_int8=True)
    picked = []
    for ch in (cfg.ch, (32, 64)):
        for a, b in zip(ch, ch[1:]):
            down = unet.strided_int8_transition(cfg, a, b)
            up = unet.strided_int8_transition(cfg, b, a, up=True)
            assert down == strided_int8_profitable(a, b)
            assert up == strided_int8_profitable(b, a, up=True)
            picked += [f"down {a}->{b}"] * down + [f"up {b}->{a}"] * up
    assert picked == ["down 32->64", "up 64->32", "up 256->192",
                      "down 32->64", "up 64->32"]
    off = dataclasses.replace(cfg, strided_int8=False)
    assert not unet.strided_int8_transition(off, 32, 64)


def test_prepare_params_quantises_the_int8_transitions():
    """prepare_params quantises exactly the int8 transitions, once, from the
    fp32 weights; a cast tree without them raises."""
    config = load_config(os.path.join(REPO, "configs", "audio_tiny.yml"))
    cfg = dataclasses.replace(unet.ModelConfig.from_config(config),
                              ch=(32, 64, 96), strided_int8=True,
                              dtype=torch.bfloat16)
    params = unet.init_model(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    p = unet.prepare_params(params, cfg)
    down = [s["down"] for s in p["down_modules"]["stages"][1:]]
    up = [s["up"] for s in p["up_modules"]["stages"][1:]]
    assert ["wq" in d for d in down] == [True, False]
    assert ["wq" in u for u in up] == [True, False]
    wq, s_w = quantize_strided_weights_int8(
        params["down_modules"]["stages"][1]["down"]["w"])
    assert torch.equal(down[0]["wq"], wq) and torch.equal(down[0]["w_scale"], s_w)
    assert down[0]["w"].dtype == torch.bfloat16
    cast = unet._cast_conv_weights(params, torch.bfloat16)
    xf = torch.zeros((1, 8, cfg.f_size * cfg.channels))
    with pytest.raises(ValueError, match="int8 taps"):
        unet.apply_model_flat_io(cast, xf, torch.tensor([3]), cfg)


@pytest.mark.parametrize("up", [False, True])
def test_wrappers_default_to_the_kernel_group(up):
    """On the CPU the wrappers run their twins with the CUDA kernel's group
    (an output tile of 8 × 16 positions, one input position of halo) unless
    ``twin_route`` sets another."""
    ci, co = (64, 32) if up else (32, 64)
    t, f = (16, 16) if up else (32, 64)
    d = _inputs(ci, co, t, f, up, seed=3)
    wq, s_w = quantize_strided_weights_int8(_t(d["w"]))
    kw = dict(c_in=ci, c_out=co, want_stats=True)
    if up:
        kw["residual"] = _t(d["res"])
    fn, plain = ((conv_up_flat, conv_up_flat_int8_plain) if up
                 else (conv_down_flat, conv_down_flat_int8_plain))
    out = fn(_t(d["x"]), wq, _t(d["b"]), w_scale=s_w, **kw)
    ref = plain(_t(d["x"]), wq, s_w, _t(d["b"]), q_tile=STRIDED_INT8_TILE,
                q_halo=STRIDED_INT8_HALO, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    whole = plain(_t(d["x"]), wq, s_w, _t(d["b"]), q_tile=(None, None),
                  q_halo=(0, 0), **kw)
    assert not torch.equal(out[0], whole[0])  # the groups differ
    with twin_route(int8_group={"strided": ((None, None), (0, 0))}):
        again = fn(_t(d["x"]), wq, _t(d["b"]), w_scale=s_w, **kw)
    assert torch.equal(again[0], whole[0])
