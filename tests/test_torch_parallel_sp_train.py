"""The port's sequence-parallel training step on gloo ranks on the CPU, at
the tiny config with non-zero GN3 weights: an sp = 2 step (two ranks) and a
dp × sp = 2 × 2 step (four ranks) against one process's step on the same
draws, grad_accum 1 and 2 (a dp × sp × A step is a single-device
grad_accum dp·A step), with the port's own draws (FNet dropout on: every sp
rank draws the same masks) and with injected ones.

The steps run in fp64. In fp32 the sp ranks' other order of summation
moves a gradient by a few 1e-7 of its leaf's scale, which AdamW turns into
up to 1.1e-4 of the scale of the zero-initialised LayerNorm biases of the
FNet (5e-9 absolute; their gradients are near the optimizer's eps), so
fp32 cannot tell a wrong collective from rounding at 1e-5 a leaf; fp64
can. The fp32 steps are held against the JAX package's sp step in
``tests/test_torch_parallel_sp_train_jax*.py``."""

import contextlib

import numpy as np
import pytest
import torch

import jax

from tests import torch_parallel_workers as workers
from tests.torch_dist import run_ranks

B, T = 2, 16
SEED = 123


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
    """{mesh: (the ranks' results, one process's)}."""
    params = jax.tree_util.tree_map(lambda v: v.numpy().copy(),
                                    workers.tiny_params())
    rng = np.random.default_rng(7)
    x0 = 0.5 * rng.standard_normal((B, 2, T, 16))
    draws = (np.array([3, 40]), rng.standard_normal((B, 2, T, 16)))
    out = {}
    for name, dp in (("sp2", 1), ("dp2xsp2", 2)):
        ranks = run_ranks(workers.sp_train, 2 * dp,
                          tmp_path_factory.mktemp(name), params, x0, draws,
                          SEED, dp, 2)
        with _threads(1):
            one = workers.train_steps(params, x0, draws, SEED,
                                      grad_accum=dp, dp=1)
        out[name] = (ranks, one)
    return out


@pytest.mark.parametrize("draws", ["drawn", "injected"])
@pytest.mark.parametrize("mesh", ["sp2", "dp2xsp2"])
def test_sp_train_step_matches_one_process(steps, mesh, draws):
    """The loss within 1e-5 relative and every leaf of parameters, optimizer
    state and EMA within 1e-5 of its scale (max|leaf|) of one process's
    step (an sp = 2 step against grad_accum 1, 2 × 2 against grad_accum
    2); every rank holds the same state, bit for bit."""
    ranks, one = steps[mesh]
    ref_state, ref_metrics = one[draws]
    first = ranks[0][draws][0]
    for rank, res in enumerate(ranks):
        state, metrics = res[draws]
        assert metrics["loss"] == pytest.approx(ref_metrics["loss"],
                                                rel=1e-5), rank
        assert state.keys() == ref_state.keys()
        assert int(state[".step"]) == 1
        for k, ref in ref_state.items():
            np.testing.assert_array_equal(state[k], first[k],
                                          err_msg=f"rank {rank} {k}")
            scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
            assert np.abs(state[k] - ref).max(initial=0.0) <= 1e-5 * scale, \
                (rank, k)
