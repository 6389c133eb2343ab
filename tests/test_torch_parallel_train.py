"""The port's data-parallel training step on two gloo ranks on the CPU, at
the tiny config: a dp = 2, grad_accum 1 step against one process's
grad_accum 2 step (loss, gradient norm, parameters, optimizer state, EMA),
with the port's own draws (FNet dropout on) and with injected ones; and the
dp step with the JAX step's own draws injected against the JAX package's
step, through the weight bridge."""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_workers as workers
from tests.torch_dist import run_ranks

B, T = 2, 16
SEED = 123


def _jax_draws(root, grad_accum):
    """(t, e) of the JAX step's first step at grad_accum A: fold_in(root, 0)
    → split 3 → antithetic t from t_key; the noise from e_key whole at
    A = 1, microbatch g's from fold_in(e_key, g) above that."""
    from ddim_audio_tpu.training import train_step as jtrain

    t_key, e_key, _ = jax.random.split(jax.random.fold_in(root, 0), 3)
    t = np.array(jtrain.antithetic_timesteps(t_key, B, 50))
    if grad_accum == 1:
        return t.astype(np.int64), np.array(jax.random.normal(
            e_key, (B, 2, T, 16), jnp.float32))
    mb = B // grad_accum
    e = np.concatenate([np.array(jax.random.normal(
        jax.random.fold_in(e_key, jnp.uint32(g)), (mb, 2, T, 16),
        jnp.float32)) for g in range(grad_accum)])
    return t.astype(np.int64), e


@contextlib.contextmanager
def _threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(the ranks' steps, one process's grad_accum 2 step, x0, params). One
    process runs on one thread, as each rank does, so that the CPU's
    reductions block the same way on both sides."""
    params = jax.tree_util.tree_map(lambda v: v.numpy().copy(),
                                    workers.tiny_params())
    x0 = (0.5 * np.random.default_rng(7).standard_normal((B, 2, T, 16))
          ).astype(np.float32)
    draws = _jax_draws(jax.random.key(9), 1)
    ranks = run_ranks(workers.dp_train, 2, tmp_path_factory.mktemp("train"),
                      params, x0, draws, SEED)
    with _threads(1):
        one = workers.train_steps(params, x0, draws, SEED, grad_accum=2, dp=1)
    return ranks, one, x0, params


@pytest.mark.parametrize("draws", ["drawn", "injected"])
def test_dp_train_step_equals_grad_accum2(steps, draws):
    """dp = 2, grad_accum 1 against one process at grad_accum 2: rank d runs
    microbatch d with microbatch d's draws (``micro_generator``: its noise
    and dropout masks depend on the step and the microbatch's global index
    alone), and one all-reduce adds the two ranks' loss and gradient sums:
    the same numbers as one process's two microbatches, bit for bit for
    every leaf and metric (the criterion asks 1e-6 relative)."""
    ranks, one, _, _ = steps
    ref_state, ref_metrics = one[draws]
    for rank, res in enumerate(ranks):
        state, metrics = res[draws]
        assert metrics == ref_metrics, rank
        assert state.keys() == ref_state.keys()
        assert int(state[".step"]) == 1
        for k in ref_state:
            np.testing.assert_array_equal(state[k], ref_state[k],
                                          err_msg=f"rank {rank} {k}")


def test_dp_train_step_matches_jax(steps):
    """The dp = 2 step with the JAX step's own draws injected against the
    JAX package's step (grad_accum 1, whose tests hold its dp mesh step
    equal to it): loss and gradient norm within 1e-4 relative, parameters
    and EMA within 5e-7 absolute plus 1e-5 relative, the tolerances of
    tests/test_torch_train_step.py (an Adam-type step moves a parameter by
    about lr · sign(g) = 5e-5 here)."""
    from ddim_audio_tpu.checkpoint import _flatten
    from ddim_audio_tpu.config import load_config as jax_load_config
    from ddim_audio_tpu.diffusion.schedules import make_schedule
    from ddim_audio_tpu.models import unet as junet
    from ddim_audio_tpu.training import train_step as jtrain

    ranks, _, x0, params = steps
    jconfig = jax_load_config(os.path.join(workers.REPO, "configs",
                                           "audio_tiny.yml"))
    jconfig.model.transformers.kwargs.hidden_dropout_prob = 0.0
    jcfg = junet.ModelConfig.from_config(jconfig)
    jstate, jtx = jtrain.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jconfig.optimization,
        use_ema=True)
    jstep = jtrain.make_train_step(
        jcfg, jconfig, make_schedule("linear", 1e-4, 0.02, 50).alphas_cumprod,
        jtx)
    jstate, jmetrics = jstep(jstate, jnp.asarray(x0), jax.random.key(9))
    ref = {k: np.asarray(v) for k, v in _flatten(jstate).items()}
    for res in ranks:
        state, metrics = res["injected"]
        for k in ("loss", "grad_norm"):
            assert metrics[k] == pytest.approx(float(jmetrics[k]), rel=1e-4), k
        assert state.keys() == ref.keys()
        for k in ref:
            if k.startswith((".params", ".ema")):
                np.testing.assert_allclose(state[k], ref[k], rtol=1e-5,
                                           atol=5e-7, err_msg=k)
