"""The statistics sums (``ops.sums``): the plain sums of the CPU route
against numpy in float64, and the wrappers' partial sums and the glue's
channel sums built on them. On the card (``gpu``) the kernel is held against
the plain sums and against itself at B = 1: a sample's sums must not depend
on its batch."""

import numpy as np
import pytest
import torch

from ddim_audio_tpu_torch.ops.sums import (ROWS, batch_sums,
                                                 batch_sums_plain,
                                                 partials_sum)
from ddim_audio_tpu_torch.ops.flat_resblock import channel_sums

torch.set_num_threads(2)


def _ref(x, squares):
    v = x.float().double().numpy()
    out = [v.sum(axis=1)] + ([np.square(v).sum(axis=1)] if squares else [])
    return np.stack(out, axis=1)


@pytest.mark.parametrize("squares", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_sums_matches_numpy(dtype, squares):
    """[B, N, K] → [B, 1 + squares, K] fp32, within 1e-5 of the largest
    sum against float64 sums of the same values."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 700, 40)).astype(
        np.float32)).to(dtype)
    out = batch_sums(x, squares)
    assert out.shape == (3, 1 + squares, 40) and out.dtype == torch.float32
    ref = _ref(x, squares)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    torch.testing.assert_close(out, batch_sums_plain(x, squares), rtol=0,
                               atol=0)


def test_partials_sum_folds_the_tiles():
    """A kernel's partials [B, tiles, 2, C] → (Σ, Σ²) [B, C] each."""
    rng = np.random.default_rng(1)
    stats = torch.from_numpy(rng.standard_normal((2, 9, 2, 16)).astype(
        np.float32))
    s1, s2 = partials_sum(stats)
    want = stats.double().sum(dim=1)
    assert s1.shape == s2.shape == (2, 16)
    torch.testing.assert_close(s1.double(), want[:, 0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s2.double(), want[:, 1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_sums_match_numpy(dtype):
    """The glue's per-(sample, channel) (Σ, Σ²) over T and F of a flat
    state [B, T, F·C]."""
    rng = np.random.default_rng(2)
    b, t, f, c = 2, 6, 4, 16
    x = torch.from_numpy(rng.standard_normal((b, t, f * c)).astype(
        np.float32)).to(dtype)
    s1, s2 = channel_sums(x, c)
    v = x.float().double().numpy().reshape(b, t * f, c)
    np.testing.assert_allclose(s1.numpy(), v.sum(axis=1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.square(v).sum(axis=1),
                               rtol=1e-5, atol=1e-5)


def test_batch_sums_refuses_other_shapes():
    with pytest.raises(ValueError, match=r"\[B, N, K\]"):
        batch_sums(torch.zeros(2, 3))


# --------------------------------------------------- on the card (gpu) ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("squares", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(300, 40), (5000, 64), (300_000, 32)])
def test_batch_sums_kernel_on_gpu(cuda, dtype, squares, n, k):
    """The kernel against the plain sums (1e-5 of the largest), one launch
    a pass over ROWS rows, and each sample's sums at B = 1 bit-equal to its
    slice of B = 3."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, n, k, generator=g, device=cuda).to(dtype)
    passes, rows = 0, n
    while True:
        passes += 1
        rows = -(-rows // ROWS)
        if rows == 1:
            break
    before = batch_sums.launches
    out = batch_sums(x, squares)
    assert batch_sums.launches == before + passes
    xd = x.double()
    ref = torch.stack([xd.sum(dim=1)] + ([xd.square().sum(dim=1)] if squares
                                          else []), dim=1)
    err = (out.double() - ref).abs().max() / ref.abs().max()
    assert err <= 1e-5, err
    for j in range(3):
        assert torch.equal(batch_sums(x[j:j + 1], squares), out[j:j + 1])
