"""DDPM ("ddpm_steps") ancestral sampler math (port of
``ddim_audio_tpu/sampling/ddpm.py``).

alpha_bar is re-derived with a prepended zero beta; per step with a_t,
a_{t-1}:

    beta_t = 1 - a_t / a_{t-1}
    x0     = sqrt(1/a_t) x - sqrt(1/a_t - 1) eps, clamped to [-1, 1]
    mean   = (sqrt(a_{t-1}) beta_t x0 + sqrt(1-beta_t)(1-a_{t-1}) x) / (1-a_t)
    x_next = mean + 1[t>0] * sqrt(beta_t) * N(0,1)      (fixedlarge variance)

The coefficients are precomputed on the host in float64 from the
float32-rounded betas; the t = 0 mask lives in ``noise_scale``.
"""

from __future__ import annotations

import numpy as np


def ddpm_coefficients(betas: np.ndarray, seq) -> dict:
    """Per-step arrays (step 0 = highest timestep). Keys: t int32[K]; at,
    coef_x0, coef_x, noise_scale float32[K]."""
    b32 = np.asarray(betas, dtype=np.float32).astype(np.float64)
    abar = np.cumprod(1.0 - np.concatenate([[0.0], b32]))  # abar[t+1] = a_bar_t
    seq = [int(s) for s in seq]
    seq_next = [-1] + seq[:-1]
    ii = np.array(seq[::-1], dtype=np.int64)
    jj = np.array(seq_next[::-1], dtype=np.int64)
    at = abar[ii + 1]
    atm1 = abar[jj + 1]
    beta_t = 1.0 - at / atm1
    coef_x0 = np.sqrt(atm1) * beta_t / (1.0 - at)
    coef_x = np.sqrt(1.0 - beta_t) * (1.0 - atm1) / (1.0 - at)
    noise_scale = np.where(ii == 0, 0.0, np.exp(0.5 * np.log(beta_t)))
    return {
        "t": ii.astype(np.int32),
        "at": at.astype(np.float32),
        "coef_x0": coef_x0.astype(np.float32),
        "coef_x": coef_x.astype(np.float32),
        "noise_scale": noise_scale.astype(np.float32),
    }


def ddpm_step(x, eps, at, coef_x0, coef_x, noise_scale, noise):
    """One DDPM update on tensors; the coefficients are float32 scalars (the
    powers are taken in float32). Returns (x0_pred_clamped, x_next)."""
    one = np.float32(1.0)
    at = np.float32(at)
    x0 = float((one / at) ** np.float32(0.5)) * x \
        - float((one / at - one) ** np.float32(0.5)) * eps
    x0 = x0.clamp(-1.0, 1.0)
    x_next = (float(np.float32(coef_x0)) * x0 + float(np.float32(coef_x)) * x
              + float(np.float32(noise_scale)) * noise)
    return x0, x_next
