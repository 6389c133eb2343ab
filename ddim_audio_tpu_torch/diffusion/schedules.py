"""Diffusion noise schedules.

Capability parity with the reference schedule construction
(``runners/diffusion.py:32-62`` — five beta schedules — and ``:103-128`` —
cumulative-product alphas with a prepended 1, posterior variance, and the
fixedlarge/fixedsmall log-variance). Everything here is pure numpy computed
once on the host, identical to ``ddim_audio_tpu/diffusion/schedules.py`` (the
port's tests hold the two equal).

Golden values (verified against the executed reference): linear(1e-4, 0.02,
1000) gives alpha_bar[0] = 0.9999, alpha_bar[999] ≈ 4.0358e-5.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def get_beta_schedule(
    beta_schedule: str,
    *,
    beta_start: float,
    beta_end: float,
    num_diffusion_timesteps: int,
) -> np.ndarray:
    """Return betas[T] (float64), one of: quad, linear, const, jsd, sigmoid."""
    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, T, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":
        # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (T,)
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule arrays (float64 host numpy).

    ``alphas_cumprod`` is the reference's ``self.alphas``
    (``runners/diffusion.py:109-115``): cumprod over ``[1] + (1-betas)`` with
    the leading 1 dropped, i.e. alpha_bar_t for t = 0..T-1.
    ``alphas_cumprod_prev[t]`` = alpha_bar_{t-1} with alpha_bar_{-1} = 1.
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    posterior_variance: np.ndarray
    logvar_fixedlarge: np.ndarray
    logvar_fixedsmall: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(
    beta_schedule: str = "linear",
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    num_diffusion_timesteps: int = 1000,
) -> DiffusionSchedule:
    betas = get_beta_schedule(
        beta_schedule,
        beta_start=beta_start,
        beta_end=beta_end,
        num_diffusion_timesteps=num_diffusion_timesteps,
    )
    alphas = np.concatenate([[1.0], 1.0 - betas]).cumprod()
    alphas_cumprod = alphas[1:]
    alphas_cumprod_prev = alphas[:-1]
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    logvar_fixedlarge = np.log(betas)
    logvar_fixedsmall = np.log(np.clip(posterior_variance, 1e-20, None))
    return DiffusionSchedule(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        posterior_variance=posterior_variance,
        logvar_fixedlarge=logvar_fixedlarge,
        logvar_fixedsmall=logvar_fixedsmall,
    )


def make_timestep_subsequence(
    num_timesteps: int, timesteps: int, skip_type: str = "uniform"
) -> list[int]:
    """Sampling sub-sequence of timesteps (``runners/diffusion.py:481-494``):
    uniform → range(0, T, T // timesteps); quad → linspace(0, sqrt(0.8 T))²
    cast to int."""
    if skip_type == "uniform":
        skip = num_timesteps // timesteps
        return list(range(0, num_timesteps, skip))
    elif skip_type == "quad":
        seq = np.linspace(0, np.sqrt(num_timesteps * 0.8), timesteps) ** 2
        return [int(s) for s in seq]
    raise NotImplementedError(skip_type)
