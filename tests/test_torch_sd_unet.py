"""The SD v1.5 UNet of the port (``models/sd_unet.py``), its classifier-free
guidance (``sampling/guidance.py``) and its runner path, at a tiny size on
the CPU (widths 32-64, 8 heads, cross-attention width 32, a 16 × 16 latent,
2 layers a block, 32 groups) with seeded random weights, against the plain
float32 reference ``tests/sd_unet_ref.py``; diffusers' sinusoid against its
formula; the published parameter count without allocating; planted faults
failing the tolerances; the modes the SD config refuses; and the U-Net +
FNet's embedding and runner chain, held against the JAX package as
before."""

import argparse
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from ddim_audio_tpu.config import load_config as jax_load_config
from ddim_audio_tpu.models import embeddings as jax_embeddings
from ddim_audio_tpu.models import unet as jax_unet
from ddim_audio_tpu.sampling.driver import ScanSampler as JaxScanSampler
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.diffusion.schedules import (
    make_schedule, make_timestep_subsequence)
from ddim_audio_tpu_torch.models import embeddings, sd_unet
from ddim_audio_tpu_torch.models.unet import ModelConfig
from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
from ddim_audio_tpu_torch.sampling.driver import ScanSampler
from ddim_audio_tpu_torch.sampling.guidance import (guidance_rows,
                                                    guided_denoiser)
from ddim_audio_tpu_torch.utils.namespace import dict2namespace
from ddim_audio_tpu_torch.weights import params_from_jax

from . import sd_unet_ref as ref

torch.set_num_threads(2)
CONFIG = "configs/riffusion_sd15.yml"
TINY = {"block_out_channels": [32, 64, 64, 64], "cross_attention_dim": 32,
        "sample_size": 16}
SCALE = 7.0
# float32 on both sides: the port (channels-last convs, SDPA, joined q, k,
# v) and the reference (NCHW convs, attention written out) sum in other
# orders; their ε differ by ~1e-6 of its norm
TOL_FP32 = 1e-5
# bf16 operands and activations against float32: 2^-8 a rounding over ~40
# layers gives ~2% of ε's norm (1.6-1.9% read on these seeds)
TOL_BF16 = 4e-2


def _raw(**sampling) -> dict:
    raw = yaml.safe_load(open(CONFIG))
    raw["model"].update(TINY)
    raw["sampling"].update(num_samples=2, dtype="float32", **sampling)
    return raw


def _cfg(dtype=torch.float32) -> sd_unet.SDUNetConfig:
    cfg = sd_unet.SDUNetConfig.from_config(dict2namespace(_raw()))
    return dataclasses.replace(cfg, dtype=dtype)


def _params(seed: int) -> dict:
    """The port's init, with norm gains 1 + 0.1·N and biases 0.1·N so that
    no norm is the identity."""
    gen = torch.Generator().manual_seed(seed)
    params = sd_unet.init_model(gen, _cfg(), device="cpu")

    def spread(t):
        if isinstance(t, list):
            return [spread(v) for v in t]
        if "g" in t and "b" in t and t["g"].ndim == 1:
            c = t["g"].shape[0]
            return {"g": 1.0 + 0.1 * torch.randn(c, generator=gen),
                    "b": 0.1 * torch.randn(c, generator=gen)}
        return {k: spread(v) if isinstance(v, (dict, list)) else v
                for k, v in t.items()}

    return spread(params)


def _inputs(seed: int, n: int = 2):
    gen = torch.Generator().manual_seed(1000 + seed)
    c = _cfg()
    x = torch.randn(n, 4, c.sample_size, c.sample_size, generator=gen)
    text = torch.randn(n, c.text_tokens, c.cross_attention_dim, generator=gen)
    uncond = torch.randn(c.text_tokens, c.cross_attention_dim, generator=gen)
    return x, text, uncond


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def _runner(tmp_path, timesteps: int, **sampling) -> Diffusion:
    args = argparse.Namespace(seed=7, timesteps=timesteps,
                              skip_type="uniform", eta=0.0,
                              sample_type="generalized", sequence=None,
                              image_folder=str(tmp_path / "latents"),
                              log_path=str(tmp_path))
    return Diffusion(args, dict2namespace(_raw(**sampling)), device="cpu")


def _abar():
    return ref.alphas_cumprod(_raw()["diffusion"])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_FP32),
                                       (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_on_both_guidance_rows(dtype, tol, seed):
    params = _params(seed)
    x, text, uncond = _inputs(seed)
    rows = guidance_rows(text, uncond)
    x2, t2 = torch.cat([x, x]), torch.tensor([981, 981, 3, 3])
    got = sd_unet.apply_model(params, x2, t2, rows, _cfg(dtype)).float()
    with torch.no_grad():
        want = ref.Model(_raw()["model"])(params, x2, t2, rows)
    for half in (slice(0, 2), slice(2, 4)):  # unconditional, text
        assert _rel(got[half], want[half]) < tol


def _first_step_program(params, x, text, uncond, cfg, swap=False):
    """The first step of a 50-step chain through the sampler's own step,
    with the guidance rows [uncond; text], or [text; uncond] (``swap``)."""
    seq = make_timestep_subsequence(1000, 50, "uniform")
    sched = make_schedule("quad", 0.00085, 0.012, 1000)

    def unet(p, xx, t, cond):
        return sd_unet.apply_model(p, xx, t, cond, cfg)

    sampler = ScanSampler(guided_denoiser(unet, SCALE))
    coeffs = sampler._coeff_arrays(sched, seq, 0.0)
    rows = guidance_rows(text, uncond)
    if swap:
        rows = rows.roll(text.shape[0], dims=0)
    prepared = {"unet": sd_unet.prepare_params(params, cfg), "cond": rows}
    with torch.no_grad():
        return sampler._step(prepared, x, coeffs, 0, None)[1]


def _first_step_reference(params, x, text, uncond):
    t, a, a_next = ref.ddim_plan(_abar(), 50)[0]
    model = ref.Model(_raw()["model"])
    tt = torch.full((x.shape[0],), t)
    with torch.no_grad():
        eps_u = model(params, x, tt, uncond.expand(x.shape[0], *uncond.shape))
        eps = eps_u + SCALE * (model(params, x, tt, text) - eps_u)
        x0 = (x - eps * np.sqrt(1.0 - a)) / np.sqrt(a)
        return np.sqrt(a_next) * x0 + np.sqrt(1.0 - a_next) * eps


def test_one_guided_ddim_step():
    params = _params(2)
    x, text, uncond = _inputs(2)
    got = _first_step_program(params, x, text, uncond, _cfg())
    want = _first_step_reference(params, x, text, uncond)
    assert _rel(got, want) < TOL_FP32
    assert _rel(got, x) > 1e-3  # the step moves the state


def test_three_step_chain_through_the_runner(tmp_path):
    runner = _runner(tmp_path, 3)
    assert runner.sd and isinstance(runner.model_cfg, sd_unet.SDUNetConfig)
    params = _params(3)
    x, text, uncond = _inputs(3)
    got = runner.sample_last_only(params, x, (text, uncond))
    want = ref.guided_chain(ref.Model(_raw()["model"]), params, x, text,
                            uncond, _abar(), 3, SCALE)[-1]
    assert got.shape == (2, 4, 16, 16)
    assert _rel(got, want) < TOL_FP32
    for j in range(2):
        saved = np.load(os.path.join(runner.args.image_folder,
                                     f"{j}_final.npy"))
        np.testing.assert_array_equal(saved, got[j])
    # without embeddings the runner draws them from its seed
    drawn = runner.sample_last_only(params, x)
    again = runner.sample_last_only(params, x,
                                    runner.draw_conditioning(x.shape[0]))
    np.testing.assert_array_equal(drawn, again)
    assert runner.start_noise().shape == (2, 4, 16, 16)


@pytest.mark.parametrize("dim,flip,shift", [(320, True, 0), (32, False, 1),
                                            (7, True, 0)])
def test_timestep_sinusoid_against_its_formula(dim, flip, shift):
    t = torch.tensor([0, 1, 20, 500, 981, 999])
    got = embeddings.timestep_sinusoid(t, dim, flip_sin_to_cos=flip,
                                       freq_shift=shift).double().numpy()
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / (half - shift))
    arg = t.numpy()[:, None] * freqs[None, :]
    sin, cos = np.sin(arg), np.cos(arg)
    want = np.concatenate([cos, sin] if flip else [sin, cos], axis=1)
    if dim % 2:
        want = np.pad(want, ((0, 0), (0, 1)))
    # float32 arguments: t·f rounds by up to 999 · 2^-24 ≈ 6e-5
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got.shape == (6, dim)


def test_count_params_without_allocating(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("count_params allocated a tensor")

    monkeypatch.setattr(torch, "rand", refuse)
    assert sd_unet.count_params(sd_unet.SDUNetConfig()) == 859_520_964
    monkeypatch.undo()
    tiny = sum(v.numel() for v in sd_unet._leaves(_params(4)))
    assert sd_unet.count_params(_cfg()) == tiny


@pytest.mark.parametrize("fault", ["no_cross_attention", "swapped_rows"])
def test_a_fault_fails_the_tolerance(monkeypatch, fault):
    params = _params(5)
    x, text, uncond = _inputs(5)
    want = _first_step_reference(params, x, text, uncond)
    if fault == "no_cross_attention":
        monkeypatch.setattr(sd_unet, "cross_attention",
                            lambda p, h, cond, heads: torch.zeros_like(h))
    got = _first_step_program(params, x, text, uncond, _cfg(),
                              swap=fault == "swapped_rows")
    assert _rel(got, want) > 100 * TOL_FP32


@pytest.mark.parametrize("mode", ["sequence", "interpolation", "fid", "train",
                                  "test"])
def test_the_sd_config_refuses_other_modes(tmp_path, mode):
    runner = _runner(tmp_path, 2)
    if mode == "train":
        call = runner.train
    elif mode == "test":
        call = runner.test
    else:
        setattr(runner.args, mode, 3 if mode == "sequence" else True)
        call = runner.sample
    with pytest.raises(NotImplementedError, match="sd_unet") as err:
        call()
    assert {"sequence": "--sequence", "interpolation": "--interpolation",
            "fid": "--fid", "train": "training", "test": "--test"}[mode] \
        in str(err.value)


def test_the_unet_embedding_and_chain_are_unchanged(tmp_path):
    """The U-Net + FNet (no ``model.type: sd_unet``) still builds its own
    config and samples through the runner as the JAX package does."""
    config = load_config("configs/audio_tiny.yml")
    config.sampling.num_samples = 2
    config.sampling.denoise = False
    args = argparse.Namespace(seed=9, timesteps=3, skip_type="uniform",
                              eta=0.0, sample_type="generalized",
                              sequence=None,
                              image_folder=str(tmp_path / "clips"))
    runner = Diffusion(args, config, device="cpu")
    assert not runner.sd and isinstance(runner.model_cfg, ModelConfig)

    jcfg_tree = jax_load_config("configs/audio_tiny.yml")
    cfg_j = jax_unet.ModelConfig.from_config(jcfg_tree)
    params_j = jax_unet.init_model(jax.random.key(4), cfg_j)
    rng = np.random.default_rng(4)
    params_j = jax.tree_util.tree_map(np.asarray, params_j)
    params_j = copy.deepcopy(params_j)
    for mod in ("down_modules", "up_modules"):
        for stage in params_j[mod]["stages"]:
            for block in stage["blocks"]:
                c = block["norm3"]["g"].shape[0]
                block["norm3"]["g"] = (1.0 + 0.2 * rng.standard_normal(c)
                                       ).astype(np.float32)
    params_t = params_from_jax(params_j, device="cpu")

    t = np.array([0, 7, 49])
    emb_j = np.asarray(jax_embeddings.beta_embedding_apply(
        jax.tree_util.tree_map(jnp.asarray, params_j["temb"]),
        jnp.asarray(t), num_timesteps=cfg_j.num_timesteps))
    emb_t = embeddings.beta_embedding_apply(
        params_t["temb"], torch.from_numpy(t),
        num_timesteps=runner.model_cfg.num_timesteps)
    np.testing.assert_allclose(emb_t.numpy(), emb_j, atol=1e-6, rtol=0)

    x = runner.start_noise()
    got = runner.sample_last_only(params_t, x)
    seq = make_timestep_subsequence(runner.num_timesteps, 3, "uniform")
    pj = jax.tree_util.tree_map(jnp.asarray, params_j)
    want = np.asarray(JaxScanSampler(
        lambda p, xx, tt: jax_unet.apply_model(p, xx, tt, cfg_j)
    ).sample_last(jnp.asarray(x.numpy()), seq, runner.schedule, eta=0.0,
                  params=pj))
    assert os.path.exists(os.path.join(args.image_folder, "0_final.wav"))
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max(),
                               rtol=0)
