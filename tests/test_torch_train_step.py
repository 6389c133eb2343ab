"""The training slice as a whole at the tiny config: optimizer steps of the
port's ``train_step`` with ``grad_accum`` 1 and 2 against the JAX package's
jitted step, the timesteps and the noise drawn by JAX's own keys in the test
and injected into the port (torch cannot reproduce JAX's random streams)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddim_audio_tpu.config import load_config as jax_load_config
from ddim_audio_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from ddim_audio_tpu.models import unet as junet
from ddim_audio_tpu.training import train_step as jtrain
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.training import train_step
from ddim_audio_tpu_torch.weights import (flatten_train_state, params_from_jax,
                                          train_state_from_jax)

torch.set_num_threads(2)
CONFIG = "configs/audio_tiny.yml"
B, T = 2, 16


def _configs(grad_accum=1, dropout=0.0):
    out = []
    for load in (load_config, jax_load_config):
        config = load(CONFIG)
        config.model.transformers.kwargs.hidden_dropout_prob = dropout
        config.training.grad_accum = grad_accum
        out.append(config)
    return out


@pytest.fixture(scope="module")
def model():
    """(config, jconfig, cfg, jcfg, numpy params with non-zero GN3): zero-init
    GN3 would make every resblock the identity and its inner gradients 0."""
    config, jconfig = _configs()
    cfg, jcfg = (unet.ModelConfig.from_config(config),
                 junet.ModelConfig.from_config(jconfig))
    tree = unet.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    for mod in ("down_modules", "up_modules"):
        for stage in tree[mod]["stages"]:
            for block in stage["blocks"]:
                g = block["norm3"]["g"]
                g.copy_(torch.from_numpy(
                    1.0 + 0.2 * rng.standard_normal(g.shape[0]).astype(np.float32)))
    params = jax.tree_util.tree_map(lambda v: v.numpy(), tree)
    return config, jconfig, cfg, jcfg, params


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(model, grad_accum):
    """The slice as a whole: two optimizer steps. The timesteps and the noise
    are what the JAX step draws from its own keys (fold_in(root, step) →
    split 3 → one array from e_key at grad_accum 1, fold_in(e_key, g) per
    microbatch above that). Loss and grad_norm agree to 1e-4 relative
    (the loss sums 512 squared errors per sample). After an Adam-type step a
    parameter moves by about lr · sign(g) = 5e-5 here, so parameters are held
    to 1% of that (5e-7 absolute) plus 1e-5 relative; moments relative to
    their leaf's scale."""
    _, _, cfg, jcfg, params = model
    config, jconfig = _configs(grad_accum=grad_accum)
    schedule = jax_make_schedule("linear", 1e-4, 0.02, 50)
    rng = np.random.default_rng(20 + grad_accum)
    x0 = rng.standard_normal((B, 2, T, 16)).astype(np.float32)

    jstate, jtx = jtrain.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jconfig.optimization,
        use_ema=True)
    jstep = jtrain.make_train_step(jcfg, jconfig, schedule.alphas_cumprod, jtx)
    state, tx = train_step.init_train_state(
        params_from_jax(params, device="cpu"), config.optimization, use_ema=True)
    step_fn = train_step.make_train_step(cfg, config, schedule.alphas_cumprod,
                                         tx)
    root = jax.random.key(7)
    for step in range(2):
        t_key, e_key, _ = jax.random.split(jax.random.fold_in(root, step), 3)
        t = np.array(jtrain.antithetic_timesteps(t_key, B, 50))  # writable
        if grad_accum == 1:
            e = np.array(jax.random.normal(e_key, x0.shape, jnp.float32))
        else:
            mb = B // grad_accum
            e = np.concatenate([np.asarray(jax.random.normal(
                jax.random.fold_in(e_key, jnp.uint32(g)), (mb,) + x0.shape[1:],
                jnp.float32)) for g in range(grad_accum)])
        jstate, jmetrics = jstep(jstate, jnp.asarray(x0), root)
        state, metrics = step_fn(
            state, torch.from_numpy(x0), None,
            noise_override=(torch.from_numpy(t), torch.from_numpy(e)))
        assert sorted(metrics) == sorted(jmetrics) == [
            "grad_norm", "loss", "update_norm_default"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[k].numpy(),
                                       np.asarray(jmetrics[k]), rtol=1e-4,
                                       err_msg=f"step {step} {k}")
        np.testing.assert_allclose(metrics["update_norm_default"].numpy(),
                                   np.asarray(jmetrics["update_norm_default"]),
                                   rtol=1e-3)
    from ddim_audio_tpu.checkpoint import _flatten

    ref = {k: np.asarray(v) for k, v in _flatten(jstate).items()}
    got = flatten_train_state(state)
    assert got.keys() == ref.keys() and len(got) == 421
    assert int(got[".step"]) == int(ref[".step"]) == 2
    for k in ref:
        if k.startswith((".params", ".ema")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=5e-7,
                                       err_msg=k)
        elif ref[k].ndim:
            scale = max(np.abs(ref[k]).max(), 1e-12)
            np.testing.assert_allclose(got[k] / scale, ref[k] / scale,
                                       rtol=1e-3, atol=1e-4, err_msg=k)
    # the port reads its own flattening back, leaf for leaf
    again = train_state_from_jax(got, state)
    assert all(torch.equal(a, b) for a, b in zip(
        flatten_and_order(again), flatten_and_order(state)))


def flatten_and_order(state):
    flat = flatten_train_state(state)
    return [torch.from_numpy(np.asarray(flat[k])) for k in sorted(flat)]


def test_batch_not_divisible_by_grad_accum_raises(model):
    _, _, cfg, _, params = model
    config, _ = _configs(grad_accum=3)
    state, tx = train_step.init_train_state(
        params_from_jax(params, device="cpu"), config.optimization, use_ema=False)
    step_fn = train_step.make_train_step(cfg, config, np.ones(50, np.float32),
                                         tx)
    assert state.ema is None
    with pytest.raises(ValueError, match="not divisible"):
        step_fn(state, torch.zeros(B, 2, T, 16), torch.Generator())


def test_train_step_bf16_tracks_fp32(model):
    """``model.dtype: bfloat16``: fp32 masters, optimizer state and EMA;
    activations and conv weights cast at apply; weight gradients come back
    fp32. The loss of 3 steps on the same data, timesteps and noise stays
    within 5% of the fp32 run's (the JAX package's own guard,
    ``test_train_step_bf16_tracks_fp32``)."""
    import dataclasses

    config, _, cfg, _, params = model
    rng = np.random.default_rng(31)
    x0 = torch.from_numpy(
        0.5 * rng.standard_normal((B, 2, T, 16)).astype(np.float32))
    draws = [(torch.from_numpy(rng.integers(0, 50, size=B)),
              torch.from_numpy(rng.standard_normal(x0.shape).astype(np.float32)))
             for _ in range(3)]
    traces = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        state, tx = train_step.init_train_state(
            params_from_jax(params, device="cpu"), config.optimization,
            use_ema=True)
        step_fn = train_step.make_train_step(
            dataclasses.replace(cfg, dtype=dtype), config,
            np.asarray(jax_make_schedule("linear", 1e-4, 0.02,
                                         50).alphas_cumprod), tx)
        losses = []
        for draw in draws:
            state, metrics = step_fn(state, x0, None, noise_override=draw)
            losses.append(float(metrics["loss"]))
        assert np.isfinite(losses).all(), losses
        flat = flatten_train_state(state)
        assert all(v.dtype == np.float32 for k, v in flat.items()
                   if k.startswith((".params", ".ema"))), name
        traces[name] = np.asarray(losses)
    rel = np.abs(traces["bf16"] - traces["fp32"]) / traces["fp32"]
    assert 0 < rel.max() < 0.05, (rel, traces)
