"""The port's DDIM last-only slice against the JAX package: schedules,
coefficients, a 3-step chain from the same x_T, the runner's export, the
codec and denoiser, config rules, and that the port never imports JAX."""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddim_audio_tpu.data import codec as jax_codec
from ddim_audio_tpu.diffusion import schedules as jax_sched
from ddim_audio_tpu.models import unet as jax_unet
from ddim_audio_tpu.ops.signal import denoise_2d as jax_denoise_2d
from ddim_audio_tpu.sampling import ddim as jax_ddim
from ddim_audio_tpu.sampling.driver import ScanSampler as JaxScanSampler
from ddim_audio_tpu.utils.namespace import dict2namespace
from ddim_audio_tpu_torch import config as tconfig
from ddim_audio_tpu_torch.data import codec
from ddim_audio_tpu_torch.diffusion import schedules
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.ops import launch_counts, reset_launch_counts
from ddim_audio_tpu_torch.ops.signal import denoise_2d
from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion, resolve_device
from ddim_audio_tpu_torch.sampling import ddim
from ddim_audio_tpu_torch.sampling.driver import ScanSampler
from ddim_audio_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ["quad", "linear", "const", "jsd", "sigmoid"]
TINY = {
    "channels": 2, "f_size": 16, "ch": [32, 64, 96], "krn": [3, 3, 3],
    "res": [1, 1, 1], "dtype": "float32",
    "transformers": {
        "module": "fnet",
        "kwargs": {"hidden_size": 32, "num_hidden_layers": 2,
                   "intermediate_size": 64, "hidden_act": "gelu_new",
                   "hidden_dropout_prob": 0.1, "initializer_range": 0.02,
                   "layer_norm_eps": 1e-6},
        "channels": 32, "dtype": None, "fourier_impl": "dft_matmul"},
}


def tiny_config(**sampling):
    s = {"num_samples": 1, "t_size": 16, "denoise": True, "HPI": False,
         "virtual_samplerate": 48000, "dtype": None, "tap_int8": False}
    s.update(sampling)
    return dict2namespace({
        "model": TINY,
        "diffusion": {"beta_schedule": "linear", "beta_start": 1e-4,
                      "beta_end": 0.02, "num_diffusion_timesteps": 50},
        "sampling": s,
        "data": {"dataset_kwargs": {"virtual_samplerate": 48000}},
    })


@pytest.mark.parametrize("kind", SCHEDULES)
def test_schedules_equal_jax(kind):
    a = schedules.make_schedule(kind, 1e-4, 0.02, 1000)
    b = jax_sched.make_schedule(kind, 1e-4, 0.02, 1000)
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                  "posterior_variance", "logvar_fixedlarge",
                  "logvar_fixedsmall"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    for skip in ("uniform", "quad"):
        assert (schedules.make_timestep_subsequence(1000, 100, skip)
                == jax_sched.make_timestep_subsequence(1000, 100, skip))


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_coefficients_and_step_equal_jax(eta):
    sched = schedules.make_schedule()
    seq = schedules.make_timestep_subsequence(1000, 100)
    a = ddim.ddim_coefficients(sched.alphas_cumprod, seq, eta)
    b = jax_ddim.ddim_coefficients(sched.alphas_cumprod, seq, eta)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    rng = np.random.default_rng(0)
    x, eps, noise = rng.standard_normal((3, 4, 8)).astype(np.float32)
    k = 37
    args = (a["at"][k], a["at_next"][k], a["c1"][k], a["c2"][k])
    x0, xn = ddim.ddim_step(torch.from_numpy(x), torch.from_numpy(eps), *args,
                            noise=torch.from_numpy(noise))
    j0, jn = jax_ddim.ddim_step(jnp.asarray(x), jnp.asarray(eps),
                                *(jnp.float32(v) for v in args),
                                noise=jnp.asarray(noise))
    np.testing.assert_allclose(x0.numpy(), np.asarray(j0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xn.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-6)


def test_three_step_chain_matches_jax():
    """Same x_T and weights: the port's flat kernel route (CPU twins) and its
    plain route (``conv_impl: xla``) vs the JAX ScanSampler.sample_last on its
    XLA route.
    Tolerance 1e-3 of max|x|."""
    cfg_t = unet.ModelConfig.from_config(tiny_config())
    cfg_j = dataclasses.replace(jax_unet.ModelConfig.from_config(tiny_config()),
                                conv_impl="xla")
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
    sched = schedules.make_schedule("linear", 1e-4, 0.02, 50)
    seq = [0, 16, 32]
    x = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)

    ref = np.asarray(JaxScanSampler(
        lambda p, xx, t: jax_unet.apply_model(p, xx, t, cfg_j)
    ).sample_last(jnp.asarray(x), seq, sched, eta=0.0, params=params_j))
    tol = 1e-3 * np.abs(ref).max()

    to_flat, from_flat = unet.flat_io_adapters(cfg_t)
    flat = ScanSampler(lambda p, xf, t: unet.apply_model_flat_io(p, xf, t, cfg_t))
    out_flat = from_flat(flat.sample_last(to_flat(torch.from_numpy(x)), seq,
                                          sched, params=params_t))
    cfg_plain = dataclasses.replace(cfg_t, conv_impl="xla")
    plain = ScanSampler(lambda p, xn, t: unet.apply_model(p, xn, t, cfg_plain))
    out_plain = plain.sample_last(torch.from_numpy(x), seq, sched,
                                  params=params_t)
    np.testing.assert_allclose(out_flat.numpy(), ref, atol=tol, rtol=0)
    np.testing.assert_allclose(out_plain.numpy(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_runner_sample_last_only_writes_files(tmp_path, eta):
    config = tiny_config(num_samples=2)
    args = SimpleNamespace(seed=5, timesteps=3, skip_type="uniform", eta=eta,
                           sample_type="generalized",
                           image_folder=str(tmp_path))
    runner = Diffusion(args, config, device="cpu")
    params = unet.init_model(torch.Generator().manual_seed(0),
                             runner.model_cfg, device="cpu")
    reset_launch_counts()
    out = runner.sample_last_only(params)
    assert launch_counts() == {k: 0 for k in launch_counts()}  # CPU: twins
    assert out.shape == (2, 2, 16, 16) and np.isfinite(out).all()
    for j in range(2):
        for ext in ("png", "wav"):
            assert (tmp_path / f"{j}_final.{ext}").stat().st_size > 0
    from scipy.io import wavfile

    sr, wav = wavfile.read(tmp_path / "1_final.wav")
    assert sr == 48000
    np.testing.assert_array_equal(
        wav, codec.pfft2wav(out[1].transpose(2, 1, 0), 48000))


def test_codec_and_denoise_equal_jax():
    rng = np.random.default_rng(6)
    img = rng.standard_normal((16, 40, 2)).astype(np.float32) * 0.3
    np.testing.assert_array_equal(codec.pfft2wav(img, 48000),
                                  jax_codec.pfft2wav(img, 48000))
    np.testing.assert_array_equal(codec.pfft2img(img), jax_codec.pfft2img(img))
    wide = rng.standard_normal((4, 5000)).astype(np.float32)
    np.testing.assert_array_equal(codec.limit_length_img(wide),
                                  jax_codec.limit_length_img(wide))
    x = rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
    np.testing.assert_allclose(denoise_2d(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_denoise_2d(jnp.asarray(x))),
                               atol=1e-5)


def test_config_rules():
    config = tconfig.load_config(os.path.join(REPO, "configs", "audio.yml"))
    cfg = unet.ModelConfig.from_config(config)
    assert config.sampling.tap_int8 is True and not cfg.tap_int8
    eval_cfg = tconfig.production_eval_cfg(config, cfg)  # audio.yml as shipped
    assert eval_cfg.dtype == torch.bfloat16 and eval_cfg.tap_int8
    config.sampling.tap_int8 = False
    assert not tconfig.production_eval_cfg(config, cfg).tap_int8
    assert eval_cfg.act_store is None and not eval_cfg.strided_int8
    config.sampling.act_store, config.sampling.strided_int8 = "int8", True
    eval_cfg = tconfig.production_eval_cfg(config, cfg)
    assert eval_cfg.act_store == "int8" and eval_cfg.strided_int8
    config.model.tap_int8 = True
    assert unet.ModelConfig.from_config(config).tap_int8
    config.model.act_store, config.model.strided_int8 = "int8", True
    model_cfg = unet.ModelConfig.from_config(config)
    assert model_cfg.act_store == "int8" and model_cfg.strided_int8
    for name, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                       ("torch.cuda.FloatTensor", torch.float32),
                       ("torch.FloatTensor", torch.float32),
                       ("torch.float", torch.float32), (None, torch.float32)):
        assert tconfig.resolve_dtype(name) == want


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import ddim_audio_tpu_torch, ddim_audio_tpu_torch.config\n"
        "import ddim_audio_tpu_torch.weights, ddim_audio_tpu_torch.ops\n"
        "import ddim_audio_tpu_torch.ops.flat_resblock\n"
        "import ddim_audio_tpu_torch.ops.residual_affine\n"
        "import ddim_audio_tpu_torch.ops.signal\n"
        "import ddim_audio_tpu_torch.runners.diffusion_runner\n"
        "import ddim_audio_tpu_torch.models.unet\n"
        "import ddim_audio_tpu_torch.sampling.driver\n"
        "import ddim_audio_tpu_torch.data.codec\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "(('jax.', 'jaxlib', 'ddim_audio_tpu.')) or m == 'ddim_audio_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
