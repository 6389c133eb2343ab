"""The port's denoiser against the JAX package's, on the same weights.

Weights are made once by the port's ``init_model`` (the same tree as the JAX
package's, see test_init_matches_jax_structure_and_bounds, and several times
quicker on the CPU), given non-zero final GroupNorm weights (at init GN3 = 0
makes every resblock the identity and would hide conv errors), handed to JAX
as numpy arrays and carried back with ``weights.params_from_jax``; inputs come
from a numpy seed. Geometry ch=(32, 64), res=(1, 1) (two stages: every
distinct Pallas call costs seconds of interpret-mode tracing),
f_size=16: there the JAX package runs its padded-square head/tail route, which
computes what the port's head/tail convs compute (tests/test_torch_headtail.py
holds them against the JAX head/tail kernels themselves).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.checkpoint import save_checkpoint
from ddim_audio_tpu.models import unet as jax_unet
from ddim_audio_tpu.ops.pallas.conv_head_tail import supports_head_tail
from ddim_audio_tpu.training.train_step import TrainState
from ddim_audio_tpu.utils.namespace import dict2namespace
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.weights import load_jax_checkpoint, params_from_jax

torch.set_num_threads(2)

TRANSFORMERS = {
    "module": "fnet",
    "kwargs": {"hidden_size": 32, "num_hidden_layers": 2,
               "intermediate_size": 64, "hidden_act": "gelu_new",
               "hidden_dropout_prob": 0.1, "initializer_range": 0.02,
               "layer_norm_eps": 1e-6},
    "channels": 32,
    "dtype": None,
    "fourier_impl": "dft_matmul",
}
GEOMETRY = dict(channels=2, f_size=16, ch=(32, 64), krn=(3, 3),
                res=(1, 1), num_timesteps=50)


def jax_params_nonzero_gn3(cfg_t, seed=3):
    tree = unet.init_model(torch.Generator().manual_seed(0), cfg_t,
                           device="cpu")
    params = jax.tree_util.tree_map(lambda v: jnp.asarray(v.numpy()), tree)
    rng = np.random.default_rng(seed)
    for mod in ("down_modules", "up_modules"):
        for stage in params[mod]["stages"]:
            for block in stage["blocks"]:
                c = block["norm3"]["g"].shape[0]
                block["norm3"]["g"] = jnp.asarray(
                    1.0 + 0.2 * rng.standard_normal(c).astype(np.float32))
    return params


@pytest.fixture(scope="module")
def setup():
    tcfg = dict2namespace(TRANSFORMERS)
    cfg_j = jax_unet.ModelConfig(**GEOMETRY, transformers=tcfg,
                                 conv_impl="xla")
    cfg_t = unet.ModelConfig(**GEOMETRY, transformers=tcfg)
    params_j = jax_params_nonzero_gn3(cfg_t)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    return cfg_j, cfg_t, params_j, params_t, x, t


def test_flat_io_denoiser_matches_jax_pallas(setup):
    """The port's main-path forward (flat state, fused resblocks, strided
    transitions, head/tail convs) vs the JAX flat forward with its Pallas
    kernels in interpret mode."""
    cfg_j, cfg_t, params_j, params_t, x, t = setup
    assert not supports_head_tail(2, 32, 16, hw=False)  # JAX pads the square conv
    to_flat_j, _, _ = jax_unet.flat_io_adapters(cfg_j)
    xf = to_flat_j(jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_unet.apply_model_flat_io(
            params_j, xf, jnp.asarray(t),
            dataclasses.replace(cfg_j, conv_impl="pallas"))
    to_flat_t, _ = unet.flat_io_adapters(cfg_t)
    out = unet.apply_model_flat_io(params_t, to_flat_t(torch.from_numpy(x)),
                                   torch.from_numpy(t), cfg_t)
    assert out.shape == tuple(xf.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_plain_denoiser_matches_jax_xla(setup):
    cfg_j, cfg_t, params_j, params_t, x, t = setup
    ref = jax_unet.apply_model(params_j, jnp.asarray(x), jnp.asarray(t), cfg_j)
    out = unet.apply_model(params_t, torch.from_numpy(x), torch.from_numpy(t),
                           cfg_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_flat_and_plain_routes_agree(setup):
    """Within the port: the kernel-route forward equals the plain forward
    after the flat-state layout conversion."""
    _, cfg_t, _, params_t, x, t = setup
    to_flat, from_flat = unet.flat_io_adapters(cfg_t)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    flat = from_flat(unet.apply_model_flat_io(params_t, to_flat(xt), tt, cfg_t))
    torch.testing.assert_close(flat, unet.apply_model(params_t, xt, tt, cfg_t),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepared_params_give_the_same_flat_forward(setup, dtype):
    """prepare_params (conv weights cast once; with tap_int8 the int8-stage
    weights quantised once from the fp32 weights) changes no number of the
    flat forward."""
    _, cfg_t, _, params_t, x, t = setup
    cfg = dataclasses.replace(cfg_t, dtype=dtype, tap_int8=True)
    to_flat, _ = unet.flat_io_adapters(cfg)
    xf, tt = to_flat(torch.from_numpy(x)), torch.from_numpy(t)
    prepared = unet.prepare_params(params_t, cfg)
    w = prepared["up_modules"]["tail"]["w"]
    assert w.shape == (3, 3, 32, 2) and w.dtype == dtype
    conv = prepared["down_modules"]["stages"][1]["blocks"][0]["conv1"]
    assert conv["wq"].dtype == torch.int8 and conv["w"].dtype == dtype
    assert conv["w_scale"].shape == (64,)
    torch.testing.assert_close(
        unet.apply_model_flat_io(prepared, xf, tt, cfg),
        unet.apply_model_flat_io(params_t, xf, tt, cfg), atol=0, rtol=0)


def test_flat_io_adapters_round_trip(setup):
    _, cfg_t, _, _, x, _ = setup
    to_flat, from_flat = unet.flat_io_adapters(cfg_t)
    xt = torch.from_numpy(x)
    xf = to_flat(xt)
    assert xf.shape == (2, 16, 16 * 2)
    # (f, c) lanes, c minor
    assert xf[1, 5, 7 * 2 + 1] == xt[1, 1, 5, 7]
    torch.testing.assert_close(from_flat(xf), xt, atol=0, rtol=0)


def test_audio_yml_param_count_and_structure():
    config = load_config("configs/audio.yml")
    cfg = unet.ModelConfig.from_config(config)
    params = unet.init_model(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert unet.count_params(params) == 47_155_266
    assert cfg.dtype == torch.float32 and cfg.ch == (32, 64, 96, 128, 192, 256)


def test_init_matches_jax_structure_and_bounds():
    """Same tree, shapes and init bounds as the JAX init (values differ)."""
    # three stages here (the strided transitions 32 -> 64 -> 96 and back):
    # no Pallas call is traced, so depth costs little
    geometry = dict(GEOMETRY, ch=(32, 64, 96), krn=(3, 3, 3), res=(1, 1, 1))
    tcfg = dict2namespace(TRANSFORMERS)
    cfg_j = jax_unet.ModelConfig(**geometry, transformers=tcfg, conv_impl="xla")
    cfg_t = unet.ModelConfig(**geometry, transformers=tcfg)
    pj = jax_unet.init_model(jax.random.key(0), cfg_j)
    pt = unet.init_model(torch.Generator().manual_seed(0), cfg_t,
                         device="cpu")
    leaves_j = jax.tree_util.tree_leaves_with_path(pj)
    assert unet.count_params(pt) == sum(v.size for _, v in leaves_j)
    for path, leaf in leaves_j:
        node = pt
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        name = jax.tree_util.keystr(path)
        assert tuple(node.shape) == leaf.shape, name
        leaf = np.asarray(leaf)
        if np.all(leaf == leaf.flat[0]):  # ones / zeros (norms, zero GN3)
            assert torch.all(node == float(leaf.flat[0])), name
        else:  # both uniform(-b, b): the sample maxima agree
            ratio = float(node.abs().max()) / float(np.abs(leaf).max())
            assert (0.8 if leaf.size >= 64 else 0.0) < ratio < 1.25, name


@pytest.mark.parametrize("impl", ["dft_matmul", "fft"])
def test_fourier_mixing_matches_jax(impl):
    """Re(FFT2) over (seq, hidden), both implementations, vs the JAX fft."""
    from ddim_audio_tpu.models.fnet import fourier_real_fft2 as jax_fft2
    from ddim_audio_tpu_torch.models import fnet

    x = np.random.default_rng(5).standard_normal((2, 16, 32)).astype(np.float32)
    out = fnet._FOURIER_IMPLS[impl](torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_fft2(jnp.asarray(x))),
                               atol=1e-4)


def test_transposed_conv_bridge_matches_torch_layout():
    """The stored flipped equivalent-forward kernel, mapped back to torch's
    ConvTranspose2d [in, out, kh, kw] weight, gives the JAX result."""
    from ddim_audio_tpu.models.layers import conv_transpose_apply as jax_ct
    from ddim_audio_tpu_torch.models.layers import conv_transpose_apply

    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 6, 5, 8)).astype(np.float32)
    p = {"w": rng.standard_normal((4, 4, 8, 3)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    ref = jax_ct(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    out = conv_transpose_apply(params_from_jax(p, device="cpu"),
                               torch.from_numpy(x))
    assert out.shape == (1, 12, 10, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("which", ["ema", "params"])
def test_load_jax_checkpoint(tmp_path, setup, which):
    """A checkpoint written by the JAX package's save_checkpoint loads into
    the port's tree, EMA or raw weights."""
    _, _, params_j, _, _, _ = setup
    ema = jax.tree_util.tree_map(lambda v: v * 0.5, params_j)
    state = TrainState(params=params_j, opt_state=(), ema=ema,
                       step=jnp.zeros((), jnp.int32))
    save_checkpoint(str(tmp_path), state, 7)
    loaded, meta = load_jax_checkpoint(str(tmp_path / "ckpt.npz"), which,
                                       device="cpu")
    assert meta["step"] == 7
    want = ema if which == "ema" else params_j
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = loaded
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_no_module_of_the_port_imports_jax():
    """Every module of the port (walked, so new ones are covered) and
    chip_smoke.py's own imports, in a fresh interpreter: neither jax nor the
    JAX package may get loaded."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import ddim_audio_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    if not name.endswith('__main__'):\n"
        "        importlib.import_module(name)\n"
        "for want in ('cli', 'ops.conv_head_tail', 'sampling.ddpm', "
        "'utils.device', 'ops.flat_grad', 'training.train_step', "
        "'training.optim', 'checkpoint', 'data.audio_dataset', "
        "'tools.profile_train_step', 'ops.residual_affine', "
        "'ops.conv_strided'):\n"
        "    assert 'ddim_audio_tpu_torch.' + want in names, want\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "(('jax.', 'jaxlib', 'ddim_audio_tpu.', 'flax', 'optax')) or "
        "m == 'ddim_audio_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    for path in ("chip_smoke.py", "ddim_audio_tpu_torch/__main__.py"):
        src = open(os.path.join(repo, path)).read()
        assert "import jax" not in src and "ddim_audio_tpu." not in src \
            and "ddim_audio_tpu " not in src, path


@pytest.mark.parametrize("entry", ["Diffusion", "init_model",
                                   "load_jax_checkpoint", "params_from_jax",
                                   "cli"])
def test_entry_points_default_to_the_card(entry, tmp_path, setup):
    """With no device given every entry point asks for CUDA, and raises
    where there is none (the CLI turns that into exit code 1)."""
    import logging
    from types import SimpleNamespace

    from ddim_audio_tpu_torch import cli
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, cfg_t, params_j, _, _, _ = setup
    config = load_config("configs/audio_tiny.yml")
    calls = {
        "Diffusion": lambda: Diffusion(SimpleNamespace(seed=0), config),
        "init_model": lambda: unet.init_model(
            torch.Generator().manual_seed(0), cfg_t),
        "load_jax_checkpoint": lambda: load_jax_checkpoint(
            str(tmp_path / "absent.npz")),
        "params_from_jax": lambda: params_from_jax(
            {"w": np.zeros(3, np.float32)}),
    }
    if entry == "cli":
        try:
            code = cli.main(["--config", "configs/audio_tiny.yml", "--doc",
                             "x", "--exp", str(tmp_path), "--ni", "--sample"])
        finally:
            logging.getLogger().handlers.clear()
        assert code == 1
        assert cli.build_parser().parse_args(
            ["--config", "c", "--doc", "d"]).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        calls[entry]()
