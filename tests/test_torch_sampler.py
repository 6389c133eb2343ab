"""The port's sampler driver against the JAX package's: DDPM coefficients and
step, step selection and the chunk plan, and the kept states of ``sample()``
for DDIM and DDPM. Both drivers run the same analytic denoiser, so these tests
hold the driver and the update arithmetic, not the model (the model has its
own files). torch cannot reproduce JAX's ``fold_in`` noise streams: wherever a
sampler needs noise, the same numpy noise is injected into both through
``noise_override``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddim_audio_tpu.sampling import ddpm as jax_ddpm
from ddim_audio_tpu.sampling import driver as jax_driver
from ddim_audio_tpu_torch.diffusion import schedules
from ddim_audio_tpu_torch.sampling import ddpm, driver
from ddim_audio_tpu_torch.sampling.driver import ScanSampler

torch.set_num_threads(2)

SCHED = schedules.make_schedule("linear", 1e-4, 0.02, 50)
SHAPE = (2, 2, 8, 4)


def jax_denoise(params, x, t):
    return 0.5 * jnp.sin(1.3 * x + 0.01 * t[:, None, None, None]) + params


def torch_denoise(params, x, t):
    return 0.5 * torch.sin(1.3 * x + 0.01 * t[:, None, None, None]) + params


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def _run_both(kind, seq, *, eta=0.0, select_index=None, buffer_dtype=None,
              noise=None, scan_chunk=100, timings=None):
    x = _x()
    jx, j0 = jax_driver.ScanSampler(jax_denoise, kind=kind,
                                    scan_chunk=scan_chunk).sample(
        jnp.asarray(x), seq, SCHED, eta=eta, select_index=select_index,
        noise_override=noise, params=jnp.float32(0.1),
        buffer_dtype=buffer_dtype)
    tx, t0 = ScanSampler(torch_denoise, kind=kind, scan_chunk=scan_chunk).sample(
        torch.from_numpy(x), seq, SCHED, eta=eta, select_index=select_index,
        noise_override=noise, params=0.1, buffer_dtype=buffer_dtype,
        timings=timings)
    return (jx, j0), (tx, t0)


def _assert_same(a, b, atol):
    (jx, j0), (tx, t0) = a, b
    assert len(tx) == len(jx) and len(t0) == len(j0) == len(tx) - 1
    for u, v in zip(tx + t0, jx + j0):
        assert u.dtype == np.float32 and u.shape == SHAPE
        np.testing.assert_allclose(u, np.asarray(v), atol=atol, rtol=0)


@pytest.mark.parametrize("seq", [list(range(50)), list(range(0, 50, 5)),
                                 [0, 1, 7, 30, 49], [3]])
def test_ddpm_coefficients_bit_equal(seq):
    a = ddpm.ddpm_coefficients(SCHED.betas, seq)
    b = jax_ddpm.ddpm_coefficients(SCHED.betas, seq)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    if seq[0] == 0:
        assert a["noise_scale"][-1] == 0.0  # the t = 0 mask


def test_ddpm_step_equals_jax():
    rng = np.random.default_rng(1)
    x, eps, noise = (3 * rng.standard_normal((3,) + SHAPE)).astype(np.float32)
    c = ddpm.ddpm_coefficients(SCHED.betas, list(range(0, 50, 5)))
    for k in (0, 4, 9):
        args = [c[n][k] for n in ("at", "coef_x0", "coef_x", "noise_scale")]
        x0, xn = ddpm.ddpm_step(torch.from_numpy(x), torch.from_numpy(eps),
                                *args, torch.from_numpy(noise))
        j0, jn = jax_ddpm.ddpm_step(jnp.asarray(x), jnp.asarray(eps),
                                    *(jnp.float32(v) for v in args),
                                    jnp.asarray(noise))
        assert float(x0.abs().max()) <= 1.0  # the clamp
        np.testing.assert_allclose(x0.numpy(), np.asarray(j0), atol=1e-6)
        np.testing.assert_allclose(xn.numpy(), np.asarray(jn), atol=2e-6)


@pytest.mark.parametrize("num_steps", [1, 7, 10])
@pytest.mark.parametrize("select", [None, [], [0], [-1], [0, -1], [2, 3, 4],
                                    [9, -10, 100], range(10)])
def test_selected_steps_equal_jax(num_steps, select):
    assert (driver.selected_steps(num_steps, select)
            == jax_driver.selected_steps(num_steps, select))


@pytest.mark.parametrize("scan_chunk,max_slots", [(100, 100), (3, 100),
                                                  (100, 2), (1, 1)])
@pytest.mark.parametrize("select", [None, [], [-1], [0, 5, 9], [1, 2, 3, 4],
                                    range(0, 10, 2)])
def test_chunk_plan_equals_jax(scan_chunk, max_slots, select):
    sel = driver.selected_steps(10, select)
    plan = driver._chunk_plan(10, sel, scan_chunk, max_slots)
    assert plan == jax_driver._chunk_plan(10, sel, scan_chunk, max_slots)
    assert [s for s, _, _ in plan] == [0] + [e for _, e, _ in plan][:-1]
    assert sorted(k for _, _, kept in plan for k in kept) == sel


def test_sample_ddim_sequence_selection_matches_jax():
    """The --sequence selection (a linspace of kept steps), fp32 buffers."""
    seq = schedules.make_timestep_subsequence(50, 10, "uniform")
    idx = np.linspace(1, 10, 3, dtype=np.int32)
    sel = set((10 - idx).tolist())
    a, b = _run_both("generalized", seq, select_index=sel)
    assert len(b[1]) == 3
    _assert_same(a, b, atol=1e-5)
    np.testing.assert_array_equal(b[0][0], _x())  # xs[0] is the input noise


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_sample_keep_all_matches_jax(eta):
    """select_index=None keeps every step; eta > 0 with injected noise; a
    scan_chunk that splits the run."""
    seq = schedules.make_timestep_subsequence(50, 7, "uniform")
    noise = np.random.default_rng(5).standard_normal(
        (len(seq),) + SHAPE).astype(np.float32) if eta else None
    a, b = _run_both("generalized", seq, eta=eta, noise=noise, scan_chunk=3)
    assert len(b[1]) == len(seq)
    _assert_same(a, b, atol=1e-5)


@pytest.mark.parametrize("buffer_dtype,atol", [(None, 1e-5), ("float16", 2e-3)])
def test_sample_ddpm_injected_noise_matches_jax(buffer_dtype, atol):
    seq = schedules.make_timestep_subsequence(50, 6, "uniform")
    noise = np.random.default_rng(6).standard_normal(
        (len(seq),) + SHAPE).astype(np.float32)
    a, b = _run_both("ddpm_noisy", seq, select_index=[0, 2, -1], noise=noise,
                     buffer_dtype=buffer_dtype)
    assert len(b[1]) == 3
    _assert_same(a, b, atol=atol)


def test_small_budget_forces_mid_run_drains(monkeypatch):
    """With the kept-state budget below two buffer pairs, pending buffers
    leave the device mid-run, and nothing about the result changes."""
    seq = schedules.make_timestep_subsequence(50, 8, "uniform")
    x = torch.from_numpy(_x())
    sampler = ScanSampler(torch_denoise)
    timings = {}
    ref = sampler.sample(x, seq, SCHED, params=0.1, timings=timings)
    assert timings["mid_drains"] == 0
    assert timings["compute_s"] > 0 and timings["drain_s"] >= 0
    pair = 2 * x.numel() * 4
    monkeypatch.setattr(driver, "_BUFFER_BUDGET_BYTES", 3 * pair)
    timings = {}
    got = sampler.sample(x, seq, SCHED, params=0.1, timings=timings)
    assert timings["mid_drains"] > 0
    for u, v in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(u, v)


def test_sample_last_equals_last_kept_state_and_ddpm_draws_noise():
    seq = schedules.make_timestep_subsequence(50, 5, "uniform")
    x = torch.from_numpy(_x())
    sampler = ScanSampler(torch_denoise)
    xs, _ = sampler.sample(x, seq, SCHED, params=0.1, select_index=[-1])
    last = sampler.sample_last(x, seq, SCHED, params=0.1)
    np.testing.assert_allclose(last.numpy(), xs[-1], atol=1e-6)
    ddpm_sampler = ScanSampler(torch_denoise, kind="ddpm_noisy")
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = ddpm_sampler.sample_last(x, seq, SCHED, params=0.1, generator=gen())
    b = ddpm_sampler.sample_last(x, seq, SCHED, params=0.1, generator=gen())
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    xs, x0s = ddpm_sampler.sample(x, seq, SCHED, params=0.1, generator=gen())
    np.testing.assert_allclose(xs[-1], a.numpy(), atol=1e-6)
    assert max(np.abs(p).max() for p in x0s) <= 1.0
    with pytest.raises(NotImplementedError):
        ScanSampler(torch_denoise, kind="other")
