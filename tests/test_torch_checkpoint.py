"""Checkpoints across the two packages at the tiny config: a TrainState the
JAX package saved resumes in the port (both then take the same next step), a
TrainState the port saved fills the JAX package's template, the port's
resume is bit-identical to an unbroken run, and a missing, extra or
mis-shaped leaf raises."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddim_audio_tpu import checkpoint as jcheckpoint
from ddim_audio_tpu.config import load_config as jax_load_config
from ddim_audio_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from ddim_audio_tpu.models import unet as junet
from ddim_audio_tpu.training import train_step as jtrain
from ddim_audio_tpu_torch import checkpoint
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.training import train_step
from ddim_audio_tpu_torch.weights import (flatten_train_state,
                                          load_jax_checkpoint, params_from_jax,
                                          read_checkpoint)

torch.set_num_threads(2)
CONFIG = "configs/audio_tiny.yml"
B, T = 2, 16


def _setup():
    config, jconfig = load_config(CONFIG), jax_load_config(CONFIG)
    for c in (config, jconfig):
        c.model.transformers.kwargs.hidden_dropout_prob = 0.0
        c.training.grad_accum = 1
    cfg = unet.ModelConfig.from_config(config)
    tree = unet.init_model(torch.Generator().manual_seed(1), cfg, device="cpu")
    rng = np.random.default_rng(4)
    for mod in ("down_modules", "up_modules"):
        for stage in tree[mod]["stages"]:
            for block in stage["blocks"]:
                g = block["norm3"]["g"]
                g.copy_(torch.from_numpy(
                    1.0 + 0.2 * rng.standard_normal(g.shape[0]).astype(np.float32)))
    params = jax.tree_util.tree_map(lambda v: v.numpy(), tree)
    return config, jconfig, cfg, params


def _port_state(config, params):
    return train_step.init_train_state(
        params_from_jax(params, device="cpu"), config.optimization,
        use_ema=True)


def _noise(step):
    rng = np.random.default_rng(100 + step)
    return (torch.from_numpy(rng.integers(0, 50, size=(B,))),
            torch.from_numpy(rng.standard_normal((B, 2, T, 16)).astype(np.float32)))



@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port trains 2 steps, saves, trains 2 more: (config, cfg, params,
    x0, folder with ckpt_2.npz, the state after 4 unbroken steps)."""
    config, _, cfg, params = _setup()
    folder = str(tmp_path_factory.mktemp("port_ckpt"))
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 2, T, 16)).astype(np.float32))
    state, tx = _port_state(config, params)
    step_fn = train_step.make_train_step(cfg, config, _alphas(), tx)
    for step in range(4):
        state, _ = step_fn(state, x0, None, noise_override=_noise(step))
        if step == 1:
            path = checkpoint.save_checkpoint(folder, state, 2, epoch=1)
            assert path == os.path.join(folder, "ckpt_2.npz")
    return config, cfg, params, x0, folder, state


def _alphas():
    return np.asarray(jax_make_schedule("linear", 1e-4, 0.02, 50).alphas_cumprod,
                      np.float32)


def test_jax_written_state_resumes_in_the_port(tmp_path):
    """The JAX package trains 2 steps and saves; the port loads that file
    and both take step 3 on the same batch. The JAX step draws its own
    timesteps and noise, which the test reproduces from its keys and injects
    into the port. Parameters after the step: 1% of the Adam-type step
    lr · sign(g) ≈ 5e-5 absolute, 1e-5 relative."""
    config, jconfig, cfg, params = _setup()
    jcfg = junet.ModelConfig.from_config(jconfig)
    jstate, jtx = jtrain.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jconfig.optimization,
        use_ema=True)
    jstep = jtrain.make_train_step(jcfg, jconfig, _alphas(), jtx)
    x0 = np.random.default_rng(6).standard_normal((B, 2, T, 16)).astype(np.float32)
    root = jax.random.key(3)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(x0), root)
    jcheckpoint.save_checkpoint(str(tmp_path), jstate, 2, epoch=0)

    template, tx = _port_state(config, params)
    state, meta = checkpoint.load_checkpoint(
        checkpoint.checkpoint_path(str(tmp_path)), template)
    assert meta["step"] == 2 and meta["num_leaves"] == 421
    assert int(state.step) == 2 and state.step.dtype == torch.int32
    assert int(state.opt_state["default"]["count"]) == 2
    assert int(state.opt_state["transformer"][0]["count"]) == 2
    assert int(state.opt_state["transformer"][2]["count"]) == 2  # the schedule's
    ref = {k: np.asarray(v) for k, v in jcheckpoint._flatten(jstate).items()}
    got = flatten_train_state(state)
    assert got.keys() == ref.keys()
    for k in ref:  # carried across as they are
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    t_key, e_key, _ = jax.random.split(jax.random.fold_in(root, 2), 3)
    t = np.array(jtrain.antithetic_timesteps(t_key, B, 50))
    e = np.array(jax.random.normal(e_key, x0.shape, jnp.float32))  # writable
    jstate, jmetrics = jstep(jstate, jnp.asarray(x0), root)
    step_fn = train_step.make_train_step(cfg, config, _alphas(), tx)
    state, metrics = step_fn(state, torch.from_numpy(x0), None,
                             noise_override=(torch.from_numpy(t),
                                             torch.from_numpy(e)))
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jmetrics["loss"]), rtol=1e-4)
    ref = {k: np.asarray(v) for k, v in jcheckpoint._flatten(jstate).items()}
    got = flatten_train_state(state)
    for k in ref:
        if k.startswith((".params", ".ema")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=5e-7,
                                       err_msg=k)
    # the evaluation view of the same file
    ema, _ = load_jax_checkpoint(checkpoint.checkpoint_path(str(tmp_path)),
                                 "ema", device="cpu")
    assert unet.count_params(ema) == unet.count_params(state.ema)


def test_port_written_state_loads_in_the_jax_package(port_run):
    config, cfg, params, _, folder, _ = port_run
    jconfig = jax_load_config(CONFIG)
    jtemplate, _ = jtrain.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jconfig.optimization,
        use_ema=True)
    jstate, meta = jcheckpoint.load_checkpoint(
        jcheckpoint.checkpoint_path(folder, 2), jtemplate)
    assert meta == {"step": 2, "epoch": 1, "num_leaves": 421, "format": 1}
    arrays, _ = read_checkpoint(os.path.join(folder, "ckpt.npz"))
    want = jcheckpoint._flatten(jtemplate)
    assert arrays.keys() == want.keys()        # key for key
    for k, v in want.items():
        assert arrays[k].shape == np.shape(v), k
        assert arrays[k].dtype == np.asarray(v).dtype, k
    got = jcheckpoint._flatten(jstate)
    for k in arrays:
        np.testing.assert_array_equal(np.asarray(got[k]), arrays[k], err_msg=k)
    assert int(jstate.step) == 2
    # rolling and tagged files hold the same arrays; no .tmp is left behind
    assert sorted(os.listdir(folder)) == ["ckpt.npz", "ckpt_2.npz"]


def test_port_resume_is_bit_identical(port_run):
    config, cfg, params, x0, folder, unbroken = port_run
    template, tx = _port_state(config, params)
    state, meta = checkpoint.load_checkpoint(
        checkpoint.checkpoint_path(folder), template)
    assert (meta["step"], meta["epoch"]) == (2, 1)
    step_fn = train_step.make_train_step(cfg, config, _alphas(), tx)
    for step in (2, 3):
        state, _ = step_fn(state, x0, None, noise_override=_noise(step))
    got, want = flatten_train_state(state), flatten_train_state(unbroken)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_emergency_tag_and_checkpoint_path(port_run, tmp_path):
    *_, unbroken = port_run
    path = checkpoint.save_checkpoint(str(tmp_path), unbroken, 4, epoch=2,
                                      tag="emergency")
    assert os.path.basename(path) == "ckpt_emergency.npz"
    assert checkpoint.checkpoint_path("logs") == os.path.join("logs", "ckpt.npz")
    assert checkpoint.checkpoint_path("logs", 7) == os.path.join("logs",
                                                                 "ckpt_7.npz")


@pytest.mark.parametrize("fault,error", [("missing", KeyError),
                                         ("extra", ValueError),
                                         ("shape", ValueError)])
def test_bad_checkpoint_raises(port_run, tmp_path, fault, error):
    config, cfg, params, _, folder, _ = port_run
    arrays, meta = read_checkpoint(os.path.join(folder, "ckpt.npz"))
    key = ".params['down_modules']['head']['w']"
    if fault == "missing":
        del arrays[".opt_state[1].inner_states['default'].inner_state.count"]
    elif fault == "extra":
        arrays[".params['down_modules']['head']['ghost']"] = np.zeros(3)
    else:
        arrays[key] = arrays[key][..., :-1]
    import json

    path = str(tmp_path / "bad.npz")
    np.savez(path, __meta__=json.dumps(meta), **arrays)
    template, _ = _port_state(config, params)
    with pytest.raises(error):
        checkpoint.load_checkpoint(path, template)
