"""The collectives of the port's sequence-parallel training
(``parallel/sp.py``) on two gloo ranks on the CPU, in fp64: the backward of
each autograd collective (the zero-padded halo at the halo widths the
convs use, ``psum_keep_sp`` and the bottleneck's gather) against central
finite differences of the global loss, and ``gn_flat(sp_group=…)`` (the
whole clip's statistics, partial dγ and dβ) against the unsharded
``gn_flat``."""

import numpy as np
import pytest

from tests import torch_parallel_workers as workers
from tests.torch_dist import run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(workers.sp_units, 2, tmp_path_factory.mktemp("units"))


@pytest.mark.parametrize("name", ["halo_1_1", "halo_1_2", "halo_2_1",
                                  "psum_keep_sp", "gather_time"])
def test_collective_backward_matches_finite_differences(ranks, name):
    """Each rank's gradient of its own share of the loss, gathered, is the
    gradient of the global loss (the shares' sum; for ``psum_keep_sp`` the
    loss every rank holds, counted once): within 1e-7 of max|gradient|
    (central differences at eps 1e-6 in fp64 are good to ~1e-9)."""
    for rank, res in enumerate(ranks):
        grad, fd = res[name]
        np.testing.assert_allclose(grad, fd, rtol=0,
                                   atol=1e-7 * np.abs(fd).max(),
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("what", ["out", "dx", "dgamma_dbeta"])
def test_gn_flat_sp_matches_unsharded(ranks, what):
    """gn_flat over the time blocks with the sp group: the blocks' outputs
    and dx, and dγ, dβ summed over the ranks, equal the unsharded op's
    within 1e-12 relative (fp64; another order of summation)."""
    for res in ranks:
        got, ref = res["gn_flat"][what]
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
