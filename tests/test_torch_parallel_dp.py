"""The runner's sampling on two gloo ranks on the CPU, at the tiny config:
dp = 2 and sp = 2 (last-only, ``--sequence``, DDPM, ``--interpolation``)
against one device's run of the same 2-clip batch from the same seed,
within 1e-5 absolute; rank 0 alone writes the files. (The dp
training step is in tests/test_torch_parallel_train.py, the command line
under a launcher in tests/test_torch_parallel_cli.py.)"""

import os

import numpy as np
import pytest

from ddim_audio_tpu_torch.weights import save_eval_checkpoint
from tests import torch_parallel_workers as workers
from tests.torch_dist import run_ranks

# The same fp32 arithmetic in another order: the CPU's convolutions and
# matmuls block a batch of 1 otherwise than a batch of 2 (a dp rank's
# forward differs from the 2-clip forward's by ~3e-6), and the sp route runs
# the conv twins on haloed blocks and its plain transitions in [B, T, F, C]
# where the single-device route fuses the skip adds into its transitions.
ATOL = 1e-5
RUNS = workers.DP_RUNS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, one device's) on a checkpoint of tiny weights
    with non-zero final GroupNorm weights."""
    exp = str(tmp_path_factory.mktemp("dp"))
    save_eval_checkpoint(os.path.join(exp, "logs", "run"),
                         workers.tiny_params())
    ranks = run_ranks(workers.dp_sampling, 2, exp, exp)
    single = workers.sample_runs(
        exp, [(f"one_{label}", 1, 1, method, extra)
              for label, method, extra in RUNS], "one")
    return ranks, single


LABELS = [r[0] for r in RUNS]


@pytest.mark.parametrize("mesh", ["dp", "sp"])
@pytest.mark.parametrize("label", LABELS)
def test_mesh_sampling_matches_single_device(runs, label, mesh):
    """Every rank gets the same exported clips (last-only, the kept x0 of
    ``--sequence``, DDPM, the 11 interpolation points), and they are one
    device's: each rank draws the whole batch's noise (start and per step)
    and keeps its block, and the blocks are gathered back. (dp = 2 leaves
    the 11 interpolation points whole on every rank: 2 does not divide
    them.)"""
    ranks, single = runs
    ref = single[f"one_{label}"]
    assert ref and all(r.shape[1:] == (2, 16, 16) for r in ref)
    for rank, res in enumerate(ranks):
        got = res[f"{mesh}_{label}"]
        assert len(got) == len(ref), (rank, len(got), len(ref))
        for g, r in zip(got, ref):
            assert g.shape == r.shape, (g.shape, r.shape)
            np.testing.assert_allclose(g, r, rtol=0, atol=ATOL,
                                       err_msg=f"{mesh} {label} rank {rank}")


@pytest.mark.parametrize("mesh", ["dp", "sp"])
def test_only_rank0_writes_samples(runs, mesh):
    ranks, single = runs
    for label in LABELS:
        one = single[f"one_{label}_files"]
        assert ranks[0][f"{mesh}_{label}_files"] == one and one, label
        assert ranks[1][f"{mesh}_{label}_files"] == [], label
