"""The port where the flat kernel route does not take the whole model: a
stage with 5×5 convs (``krn = (3, 5, 5)``) and ``conv_impl: xla``, at the
tiny geometry, against the JAX package on the CPU. Sampling and the eval
loss run ``apply_model`` (the 3×3 stage on the fused resblocks) where the
JAX runner falls back; training runs the flat ops on the head, tail,
transitions and the 3×3 stage and the plain block on the 5×5 stages, as the
JAX step does per stage. With ``conv_impl: xla`` sampling calls no kernel
wrapper at all."""

import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddim_audio_tpu.config import load_config as jax_load_config
from ddim_audio_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from ddim_audio_tpu.models import unet as junet
from ddim_audio_tpu.ops.signal import denoise_2d as jax_denoise_2d
from ddim_audio_tpu.runners import Diffusion as JaxDiffusion
from ddim_audio_tpu.training import train_step as jtrain
from ddim_audio_tpu_torch import ops
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.diffusion.schedules import make_timestep_subsequence
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
from ddim_audio_tpu_torch.training import train_step
from ddim_audio_tpu_torch.weights import flatten_train_state, params_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "audio_tiny.yml")
KRN = [3, 5, 5]
B, T = 2, 16


def _configs(**model):
    """(the port's config, the JAX package's), tiny with krn (3, 5, 5)."""
    out = []
    for load in (load_config, jax_load_config):
        config = load(CONFIG)
        config.model.krn = list(KRN)
        config.model.transformers.kwargs.hidden_dropout_prob = 0.0
        config.sampling.buffer_dtype = "float32"
        for k, v in model.items():
            setattr(config.model, k, v)
        out.append(config)
    return out


@pytest.fixture(scope="module")
def params():
    """numpy params of the krn (3, 5, 5) model with non-zero GN3 weights."""
    cfg = unet.ModelConfig.from_config(_configs()[0])
    tree = unet.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    for mod in ("down_modules", "up_modules"):
        for stage in tree[mod]["stages"]:
            for block in stage["blocks"]:
                g = block["norm3"]["g"]
                g.copy_(torch.from_numpy(
                    1.0 + 0.2 * rng.standard_normal(g.shape[0]).astype(
                        np.float32)))
    return jax.tree_util.tree_map(lambda v: v.numpy().copy(), tree)


def _args(folder):
    return SimpleNamespace(seed=7, timesteps=4, skip_type="uniform", eta=0.0,
                           sample_type="generalized", sequence=2,
                           image_folder=str(folder), log_path=str(folder))


class _Spy:
    """Counts the calls of every kernel wrapper where the port's modules
    hold it (a call that hands over to another wrapper counts both)."""

    def __init__(self, monkeypatch):
        import sys

        self.calls = {}
        wrappers = {id(fn): name for name, fn in ops.KERNEL_WRAPPERS.items()}
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or not mod_name.startswith("ddim_audio_tpu_torch"):
                continue
            for attr, val in list(vars(mod).items()):
                if id(val) in wrappers:
                    monkeypatch.setattr(mod, attr, self._wrap(
                        wrappers[id(val)], val))

    def _wrap(self, name, fn):
        def run(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **kw)
        run.launches = 0  # a wrapper counts its launches on its own name
        return run


def test_flat_route_predicate():
    cfg = unet.ModelConfig.from_config(_configs()[0])
    assert not unet.flat_route(cfg)
    full = unet.ModelConfig.from_config(load_config(CONFIG))
    assert unet.flat_route(full)
    assert not unet.flat_route(unet.ModelConfig.from_config(
        _configs(krn=[3, 3, 3], conv_impl="xla")[0]))


@pytest.mark.parametrize("mode", ["last_only", "sequence"])
def test_fallback_sampling_matches_jax_runner(params, tmp_path, mode):
    """The runner's sampler for a model the flat route does not take: the
    JAX runner samples through its XLA ``apply_model`` (it falls back from
    the flat route), the port through ``apply_model`` with the 3×3 stage on
    the fused resblocks; 4 DDIM steps from the same x_T, last-only (the
    carry, then ``denoise_2d``) and ``--sequence`` (the kept x0
    predictions), within 1e-4 of max|x|."""
    config, jconfig = _configs()
    x = np.random.default_rng(8).standard_normal(
        (B, 2, 16, 16)).astype(np.float32)
    runner = Diffusion(_args(tmp_path), config, device="cpu")
    jrunner = JaxDiffusion(_args(tmp_path), jconfig)
    tparams = params_from_jax(params, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    if mode == "sequence":
        sel = {0, 3}
        _, got = runner.sample_image(torch.from_numpy(x), tparams,
                                     select_index=sel)
        _, ref = jrunner.sample_image(jnp.asarray(x), jparams,
                                      select_index=sel)
        assert len(got) == len(ref) == 2
        pairs = [(g, np.asarray(r)) for g, r in zip(got, ref)]
    else:
        seq = make_timestep_subsequence(50, 4, "uniform")
        sampler, state, finalize = runner._sampler_for_state(
            torch.from_numpy(x))
        assert state.shape == x.shape  # [B, C, T, F]: not the flat state
        got = finalize(sampler.sample_last(
            state, seq, runner.schedule,
            params=runner._sampler_params(tparams, torch.from_numpy(x))))
        jsampler, jstate, jfinal = jrunner._sampler_for_state(jnp.asarray(x))
        ref = jfinal(jsampler.sample_last(
            jstate, seq, jrunner.schedule, key=jax.random.key(8),
            params=jrunner._sampler_params(jparams, x.shape[2])))
        from ddim_audio_tpu_torch.ops.signal import denoise_2d

        pairs = [(denoise_2d(got).numpy(),
                  np.asarray(jax_denoise_2d(jnp.asarray(ref))))]
    for g, r in pairs:
        scale = np.abs(r).max()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * scale)


def test_fallback_eval_loss_matches_jax(params, tmp_path):
    """The runner's eval loss (validation and ``--test``) through
    ``apply_model`` against the JAX runner's (its XLA ``apply_model``),
    within 1e-5 relative."""
    config, jconfig = _configs()
    runner = Diffusion(_args(tmp_path), config, device="cpu")
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((B, 2, T, 16)).astype(np.float32)
    e = rng.standard_normal((B, 2, T, 16)).astype(np.float32)
    t = np.array([3, 41])
    got = float(runner._eval_loss_fn(params_from_jax(params, device="cpu"))(
        torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(e)))
    jcfg = junet.ModelConfig.from_config(jconfig)
    alphas = jnp.asarray(JaxDiffusion(_args(tmp_path), jconfig)
                         .schedule.alphas_cumprod, jnp.float32)
    a = alphas[t][:, None, None, None]
    xt = jnp.asarray(x0) * jnp.sqrt(a) + jnp.asarray(e) * jnp.sqrt(1.0 - a)
    eps = junet.apply_model(jax.tree_util.tree_map(jnp.asarray, params), xt,
                            jnp.asarray(t), jcfg)
    ref = float(jnp.mean(jnp.sum(jnp.square(jnp.asarray(e) - eps),
                                 axis=(1, 2, 3))))
    assert got == pytest.approx(ref, rel=1e-5)


def test_fallback_train_step_matches_jax(params):
    """One optimizer step of a krn (3, 5, 5) model: the port runs the flat
    ops on the head, tail, transitions and the 3×3 stage and the plain block
    on the 5×5 stages; the JAX step (its XLA route on the CPU) with its own
    draws injected. The tolerances of tests/test_torch_train_step.py."""
    from ddim_audio_tpu.checkpoint import _flatten

    config, jconfig = _configs()
    cfg, jcfg = (unet.ModelConfig.from_config(config),
                 junet.ModelConfig.from_config(jconfig))
    schedule = jax_make_schedule("linear", 1e-4, 0.02, 50)
    x0 = np.random.default_rng(21).standard_normal(
        (B, 2, T, 16)).astype(np.float32)
    jstate, jtx = jtrain.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jconfig.optimization,
        use_ema=True)
    jstep = jtrain.make_train_step(jcfg, jconfig, schedule.alphas_cumprod, jtx)
    state, tx = train_step.init_train_state(
        params_from_jax(params, device="cpu"), config.optimization,
        use_ema=True)
    step_fn = train_step.make_train_step(cfg, config, schedule.alphas_cumprod,
                                         tx)
    root = jax.random.key(7)
    t_key, e_key, _ = jax.random.split(jax.random.fold_in(root, 0), 3)
    t = np.array(jtrain.antithetic_timesteps(t_key, B, 50))
    e = np.array(jax.random.normal(e_key, x0.shape, jnp.float32))
    jstate, jmetrics = jstep(jstate, jnp.asarray(x0), root)
    state, metrics = step_fn(state, torch.from_numpy(x0), None,
                             noise_override=(torch.from_numpy(t),
                                             torch.from_numpy(e)))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jmetrics[k]),
                                   rtol=1e-4, err_msg=k)
    ref = {k: np.asarray(v) for k, v in _flatten(jstate).items()}
    got = flatten_train_state(state)
    assert got.keys() == ref.keys()
    for k in ref:
        if k.startswith((".params", ".ema")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=5e-7,
                                       err_msg=k)


def test_train_forward_runs_flat_ops_around_plain_stages(params, monkeypatch):
    """The training forward of the krn (3, 5, 5) model calls the flat conv
    ops for the padded head and tail, the 3×3 stage's resblocks (2 blocks ×
    2 convs) and the transitions, and the plain block elsewhere."""
    cfg = unet.ModelConfig.from_config(_configs()[0])
    spy = _Spy(monkeypatch)
    x = torch.randn((B, 2, T, 16), generator=torch.Generator().manual_seed(1))
    unet.apply_model(params_from_jax(params, device="cpu"), x,
                     torch.tensor([3, 9]), cfg, train=True)
    assert spy.calls == {"conv3x3_flat": 2 + 2 * 2, "conv_down_flat": 2,
                         "conv_up_flat": 2}


@pytest.mark.parametrize("conv_impl,want", [
    ("xla", {}),
    # the 3×3 stage's two resblocks, fused (stage 0 down and up)
    ("auto", {"conv3x3_flat": 4}),
])
def test_plain_sampling_calls_no_kernel(params, tmp_path, monkeypatch,
                                        conv_impl, want):
    """``conv_impl: xla`` samples through ``apply_model`` without calling a
    single kernel wrapper; with ``auto`` the same fallback runs the 3×3
    stage's resblocks on ``conv3x3_flat`` (which the spy sees)."""
    config, _ = _configs(conv_impl=conv_impl)
    runner = Diffusion(_args(tmp_path), config, device="cpu")
    spy = _Spy(monkeypatch)
    x = torch.randn((1, 2, 16, 16), generator=torch.Generator().manual_seed(2))
    seq = make_timestep_subsequence(50, 1, "uniform")
    sampler, state, finalize = runner._sampler_for_state(x)
    out = finalize(sampler.sample_last(
        state, seq, runner.schedule,
        params=runner._sampler_params(params_from_jax(
            copy.deepcopy(params), device="cpu"), x)))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert spy.calls == want
