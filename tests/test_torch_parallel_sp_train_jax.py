"""The port's sp = 2 training step on two gloo ranks on the CPU against the
JAX package's sequence-parallel step (``make_train_step`` on a (dp, sp) =
(1, 2) CPU mesh, its XLA convs as ``tests/test_parallel.py`` runs it), at
the tiny config with non-zero GN3 weights, fp32: the port takes the JAX
step's own draws, injected. ``tests/test_torch_parallel_sp_train_jax22.py``
holds the dp × sp = 2 × 2 step the same way."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import mesh_utils
from jax.sharding import Mesh

from tests import torch_parallel_workers as workers
from tests.torch_dist import run_ranks

B, T = 2, 16
ROOT_SEED = 9


def jax_mesh_draws(dp: int, grad_accum: int = 1):
    """(t, e) of the JAX mesh step's first step: fold_in(root, 0) → split 3
    → antithetic t from t_key; microbatch g of dp index i draws its whole-T
    noise from fold_in(e_key, i·A + g), even at A = 1 (the mesh branch
    folds where the unsharded A = 1 step does not)."""
    from ddim_audio_tpu.training import train_step as jtrain

    t_key, e_key, _ = jax.random.split(
        jax.random.fold_in(jax.random.key(ROOT_SEED), 0), 3)
    t = np.array(jtrain.antithetic_timesteps(t_key, B, 50))
    mb = B // (dp * grad_accum)
    e = np.concatenate([np.array(jax.random.normal(
        jax.random.fold_in(e_key, jnp.uint32(i)), (mb, 2, T, 16),
        jnp.float32)) for i in range(dp * grad_accum)])
    return t.astype(np.int64), e


def jax_mesh_step(params, x0, dp: int, sp: int):
    """The JAX package's step on a (dp, sp) CPU mesh, FNet dropout off:
    (metrics, flattened state)."""
    from ddim_audio_tpu.checkpoint import _flatten
    from ddim_audio_tpu.config import load_config
    from ddim_audio_tpu.diffusion.schedules import make_schedule
    from ddim_audio_tpu.models import unet as junet
    from ddim_audio_tpu.training import train_step as jtrain

    config = load_config(os.path.join(workers.REPO, "configs",
                                      "audio_tiny.yml"))
    config.model.transformers.kwargs.hidden_dropout_prob = 0.0
    cfg = junet.ModelConfig.from_config(config)
    state, tx = jtrain.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), config.optimization,
        use_ema=True)
    mesh = Mesh(mesh_utils.create_device_mesh((dp, sp),
                                              jax.devices()[:dp * sp]),
                ("dp", "sp"))
    step = jtrain.make_train_step(
        cfg, config, make_schedule("linear", 1e-4, 0.02, 50).alphas_cumprod,
        tx, mesh=mesh)
    state, metrics = step(state, jnp.asarray(x0),
                          jax.random.key(ROOT_SEED))
    return ({k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in _flatten(state).items()})


def port_and_jax(tmp_path, dp: int, sp: int):
    params = jax.tree_util.tree_map(lambda v: v.numpy().copy(),
                                    workers.tiny_params())
    x0 = (0.5 * np.random.default_rng(11).standard_normal((B, 2, T, 16))
          ).astype(np.float32)
    # the JAX step compiles in a thread while the ranks run
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(jax_mesh_step, params, x0, dp, sp)
        ranks = run_ranks(workers.sp_train, dp * sp, tmp_path, params, x0,
                          jax_mesh_draws(dp), 0, dp, sp, ("injected",))
        return ranks, ref.result()


def check_against_jax(ranks, ref):
    """Loss and gradient norm within 1e-4 relative, parameters and EMA
    within 5e-7 absolute plus 1e-5 relative: the tolerances of
    tests/test_torch_train_step.py (an Adam-type step moves a parameter by
    about lr · sign(g) = 5e-5 here)."""
    jmetrics, jstate = ref
    for res in ranks:
        state, metrics = res["injected"]
        for k in ("loss", "grad_norm"):
            assert metrics[k] == pytest.approx(jmetrics[k], rel=1e-4), k
        assert state.keys() == jstate.keys()
        for k, want in jstate.items():
            if k.startswith((".params", ".ema")):
                np.testing.assert_allclose(state[k], want, rtol=1e-5,
                                           atol=5e-7, err_msg=k)


def test_sp2_train_step_matches_jax(tmp_path):
    check_against_jax(*port_and_jax(tmp_path, 1, 2))
