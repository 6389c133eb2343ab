"""The port's training step against the JAX package at the tiny config: the
loss, antithetic timesteps, whole-model gradients of the flat training route
(the autograd Functions over the plain twins on the CPU) against the JAX
package with ``train=True`` (on the CPU it takes its XLA route, which its own
tests hold equal to the Pallas route), remat and dropout. The optimizer steps as a whole are in
tests/test_torch_train_step.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddim_audio_tpu.config import load_config as jax_load_config
from ddim_audio_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from ddim_audio_tpu.models import unet as junet
from ddim_audio_tpu.training import losses as jlosses
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.models import fnet, unet
from ddim_audio_tpu_torch.training import losses, train_step
from ddim_audio_tpu_torch.utils.tree import tree_leaves, tree_paths
from ddim_audio_tpu_torch.weights import params_from_jax

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


def _jax_keys(params):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def test_noise_estimation_loss_matches_jax():
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
    e = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 17, 49])
    alphas = np.asarray(jax_make_schedule("linear", 1e-4, 0.02, 50).alphas_cumprod,
                        np.float32)

    def japply(p, x, tt):
        return p * x + tt[:, None, None, None] * 0.01

    def tapply(p, x, tt):
        return p * x + tt[:, None, None, None] * 0.01

    for keepdim in (False, True):
        ref = jlosses.noise_estimation_loss(
            japply, 0.7, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(e),
            jnp.asarray(alphas), keepdim=keepdim)
        got = losses.noise_estimation_loss(
            tapply, 0.7, torch.from_numpy(x0), torch.from_numpy(t),
            torch.from_numpy(e), torch.from_numpy(alphas), keepdim=keepdim)
        # summed over (C, T, F) = 256 terms, mean over the batch
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    assert losses.loss_registry["simple"] is losses.noise_estimation_loss


@pytest.mark.parametrize("n", [1, 2, 7, 14])
def test_antithetic_timesteps_shape_and_symmetry(n):
    gen = torch.Generator().manual_seed(n)
    t = train_step.antithetic_timesteps(gen, n, 50)
    assert t.shape == (n,) and t.dtype == torch.int64
    assert int(t.min()) >= 0 and int(t.max()) < 50
    half = (n + 1) // 2
    assert torch.equal(t[half:], (50 - t[:half] - 1)[:n - half])
    again = train_step.antithetic_timesteps(
        torch.Generator().manual_seed(n), n, 50)
    assert torch.equal(t, again)


def _port_grads(params_np, x, t, cfg, generator=None):
    params = params_from_jax(params_np, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = unet.apply_model(params, torch.from_numpy(x), torch.from_numpy(t),
                           cfg, train=True, generator=generator)
    grads = torch.autograd.grad((out * out).sum(), leaves)
    return out.detach(), dict(zip(tree_paths(params), grads))


def test_whole_model_gradients_match_jax(model):
    """Flat training route of the port against the JAX package's training
    forward, rtol 1e-4 / atol 2e-5 (its own whole-model tolerance,
    tests/test_pallas_conv.py), gradients relative to each leaf's scale."""
    _, _, cfg, jcfg, params = model
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 2, T, 16)).astype(np.float32)
    t = np.array([3, 40])

    def loss(p):
        out = junet.apply_model(p, jnp.asarray(x), jnp.asarray(t), jcfg,
                                train=True, rng=jax.random.key(0))
        return jnp.sum(out * out), out

    (_, ref_out), ref_g = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    out, grads = _port_grads(params, x, t, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-4,
                               atol=2e-5)
    ref = _jax_keys(ref_g)
    assert grads.keys() == ref.keys()
    for k, g in grads.items():
        scale = max(np.abs(ref[k]).max(), 1e-3)
        np.testing.assert_allclose(g.numpy() / scale, ref[k] / scale,
                                   rtol=1e-4, atol=2e-5, err_msg=k)


def test_remat_on_equals_off_and_plain_route_agrees(model):
    _, _, cfg, _, params = model
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 2, T, 16)).astype(np.float32)
    t = np.array([11, 29])
    out, grads = _port_grads(params, x, t, cfg)
    out_off, grads_off = _port_grads(params, x, t,
                                     dataclasses.replace(cfg, remat=False))
    assert torch.equal(out, out_off)
    for k in grads:  # bit for bit
        assert torch.equal(grads[k], grads_off[k]), k
    out_x, grads_x = _port_grads(params, x, t,
                                 dataclasses.replace(cfg, conv_impl="xla"))
    np.testing.assert_allclose(out.numpy(), out_x.numpy(), rtol=1e-4, atol=2e-5)
    for k in grads:
        scale = max(grads_x[k].abs().max().item(), 1e-3)
        np.testing.assert_allclose(grads[k].numpy() / scale,
                                   grads_x[k].numpy() / scale, rtol=1e-4,
                                   atol=2e-5, err_msg=k)


def test_dropout_sites_scaling_and_seed(model, monkeypatch):
    config, _, cfg, _, params = model
    # scaling: kept values are divided by keep, the rest are zero
    from ddim_audio_tpu_torch.models.layers import dropout
    x = torch.ones(200, 50)
    y = dropout(torch.Generator().manual_seed(0), x, 0.25, train=True)
    assert y.unique().tolist() == pytest.approx([0.0, 1.0 / 0.75])
    assert abs((y != 0).float().mean().item() - 0.75) < 0.02
    for args in ((None, x, 0.25, True), (torch.Generator(), x, 0.0, True),
                 (torch.Generator(), x, 0.25, False)):
        assert dropout(args[0], args[1], args[2], train=args[3]) is x

    # sites: after the embedding projection and once per FNet layer
    calls = []

    def spy(generator, x, rate, *, train):
        calls.append((tuple(x.shape), rate, train))
        return dropout(generator, x, rate, train=train)

    monkeypatch.setattr(fnet, "dropout", spy)
    tcfg = load_config(CONFIG).model.transformers  # hidden_dropout_prob 0.1
    cfg_drop = dataclasses.replace(cfg, transformers=tcfg)
    p = params_from_jax(params, device="cpu")
    rng = np.random.default_rng(10)
    xin = torch.from_numpy(rng.standard_normal((B, 2, T, 16)).astype(np.float32))
    t = torch.tensor([5, 6])

    def run(seed, train=True):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return unet.apply_model(p, xin, t, cfg_drop, train=train,
                                    generator=gen)

    a = run(1)
    hidden = tcfg.kwargs.hidden_size
    assert calls == [((B, T // 4, hidden), 0.1, True)] * (
        1 + tcfg.kwargs.num_hidden_layers)
    assert torch.equal(a, run(1))          # a fixed seed repeats
    assert not torch.equal(a, run(2))      # another seed does not
    plain = run(None, train=False)
    assert torch.equal(run(3, train=False), plain)  # eval: no dropout
    assert not torch.equal(a, run(None))   # no generator: no dropout
