"""The production-style flat forward (head/tail convs, int8 taps at C <= 96,
float taps above) against the JAX package's, both with int8 taps, at
f_size=64: there ``supports_head_tail`` holds, so the JAX package runs its
own head/tail kernels and no int8 padded-square head (which it runs at the
usual tiny f_size=16). The twin's quantisation group is set to the TPU
kernel's; at these sizes its tile is the whole sample."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.models import unet as jax_unet
from ddim_audio_tpu.ops.pallas.conv_head_tail import supports_head_tail
from ddim_audio_tpu.utils.namespace import dict2namespace
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.ops import twin_route
from ddim_audio_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

TRANSFORMERS = {
    "module": "fnet",
    "kwargs": {"hidden_size": 32, "num_hidden_layers": 1,
               "intermediate_size": 64, "hidden_act": "gelu_new",
               "hidden_dropout_prob": 0.1, "initializer_range": 0.02,
               "layer_norm_eps": 1e-6},
    "channels": 32, "dtype": None, "fourier_impl": "dft_matmul",
}
GEOMETRY = dict(channels=2, f_size=64, ch=(32, 64, 96), krn=(3, 3, 3),
                res=(1, 1, 1), num_timesteps=50)


def snr_db(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10((ref ** 2).mean() / max(((out - ref) ** 2).mean(), 1e-300))


@pytest.fixture(scope="module")
def setup():
    tcfg = dict2namespace(TRANSFORMERS)
    cfg_j = jax_unet.ModelConfig(**GEOMETRY, transformers=tcfg,
                                 conv_impl="pallas", tap_int8=True)
    cfg_t = unet.ModelConfig(**GEOMETRY, transformers=tcfg, tap_int8=True)
    assert supports_head_tail(2, 32, 64, hw=False)
    params_j = jax_unet.init_model(jax.random.key(0), cfg_j)
    rng = np.random.default_rng(3)
    for mod in ("down_modules", "up_modules"):
        for stage in params_j[mod]["stages"]:
            for block in stage["blocks"]:
                c = block["norm3"]["g"].shape[0]
                block["norm3"]["g"] = jnp.asarray(
                    1.0 + 0.2 * rng.standard_normal(c).astype(np.float32))
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               device="cpu")
    x = rng.standard_normal((1, 2, 8, 64)).astype(np.float32)
    t = np.array([17], np.int32)
    to_flat_j, _, _ = jax_unet.flat_io_adapters(cfg_j)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_unet.apply_model_flat_io(
            params_j, to_flat_j(jnp.asarray(x)), jnp.asarray(t), cfg_j))
    to_flat, _ = unet.flat_io_adapters(cfg_t)
    return cfg_t, params_t, to_flat(torch.from_numpy(x)), torch.from_numpy(t), ref


def test_production_forward_matches_jax_int8(setup):
    cfg, params, xf, t, ref = setup
    with twin_route(int8_group=((None, None), (0, 0))):
        out = unet.apply_model_flat_io(params, xf, t, cfg)
    assert out.shape == ref.shape
    assert snr_db(out.numpy(), ref) >= 50.0


def test_int8_stages_and_float_stages(setup):
    """int8 taps run at C <= 96 only; the float-tap forward differs from the
    int8 one at quantisation noise, not more."""
    cfg, params, xf, t, _ = setup
    assert [unet.tap_int8_stage(cfg, c) for c in (32, 64, 96, 128, 192, 256)] \
        == [True, True, True, False, False, False]
    cfg_f = dataclasses.replace(cfg, tap_int8=False)
    assert not any(unet.tap_int8_stage(cfg_f, c) for c in cfg.ch)
    out8 = unet.apply_model_flat_io(params, xf, t, cfg)
    outf = unet.apply_model_flat_io(params, xf, t, cfg_f)
    assert 20.0 <= snr_db(out8.numpy(), outf.numpy()) < 60.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepared_int8_weights(setup, dtype):
    """prepare_params quantises the int8 stages from the fp32 weights (not
    from the bf16 cast) and changes no number of the forward."""
    cfg, params, xf, t, _ = setup
    cfg = dataclasses.replace(cfg, dtype=dtype)
    prepared = unet.prepare_params(params, cfg)
    from ddim_audio_tpu_torch.ops.conv_flat import quantize_conv_weights_int8

    for mod in ("down_modules", "up_modules"):
        for c, src, dst in zip(cfg.ch, params[mod]["stages"],
                               prepared[mod]["stages"]):
            for bs, bd in zip(src["blocks"], dst["blocks"]):
                for name in ("conv1", "conv2"):
                    assert bd[name]["w"].dtype == dtype
                    wq, s_w = quantize_conv_weights_int8(bs[name]["w"])
                    assert torch.equal(bd[name]["wq"], wq)
                    assert torch.equal(bd[name]["w_scale"], s_w)
    assert "wq" not in params["down_modules"]["stages"][0]["blocks"][0]["conv1"]
    torch.testing.assert_close(
        unet.apply_model_flat_io(prepared, xf, t, cfg),
        unet.apply_model_flat_io(params, xf, t, cfg), atol=0, rtol=0)
