"""DDIM ("generalized_steps") sampler math.

Capability parity with the reference ``functions/denoising.py:10-52``:
iterate (i, j) over reversed (seq, seq_next) with seq_next = [-1] + seq[:-1];
per step, with a_t = alpha_bar[i] and a_next = alpha_bar[j] (1.0 at j = -1):

    x0     = (x_t - sqrt(1 - a_t) * eps) / sqrt(a_t)
    c1     = eta * sqrt((1 - a_t/a_next) * (1 - a_next) / (1 - a_t))
    c2     = sqrt((1 - a_next) - c1^2)
    x_next = sqrt(a_next) * x0 + c2 * eps + c1 * N(0, 1)

All per-step coefficients are precomputed host-side (float32-cast alphas, then
float64 arithmetic — the reference casts alphas to float32 and then does
Python-float math, functions/denoising.py:12), as in
``ddim_audio_tpu/sampling/ddim.py``; the model call is the only per-step
device work. ``ddim_step`` works on torch tensors with float32 scalar
coefficients, as the JAX package's scan does.
"""

from __future__ import annotations

import numpy as np


def ddim_coefficients(alphas_cumprod: np.ndarray, seq, eta: float) -> dict:
    """Per-scan-step arrays (step 0 = highest timestep). Keys:
    t[K] int32; at, at_next, c1, c2 float32[K]."""
    a32 = np.asarray(alphas_cumprod, dtype=np.float32).astype(np.float64)
    alpha = np.concatenate([[1.0], a32])
    seq = [int(s) for s in seq]
    seq_next = [-1] + seq[:-1]
    ii = np.array(seq[::-1], dtype=np.int64)
    jj = np.array(seq_next[::-1], dtype=np.int64)
    at = alpha[ii + 1]
    at_next = alpha[jj + 1]
    c1 = eta * np.sqrt((1 - at / at_next) * (1 - at_next) / (1 - at))
    c2 = np.sqrt((1 - at_next) - c1**2)
    return {
        "t": ii.astype(np.int32),
        "at": at.astype(np.float32),
        "at_next": at_next.astype(np.float32),
        "c1": c1.astype(np.float32),
        "c2": c2.astype(np.float32),
    }


def ddim_step(x, eps, at, at_next, c1, c2, noise=None):
    """One DDIM update on tensors; at, at_next, c1, c2 are float32 scalars
    (the square roots are taken in float32). Returns (x0_pred, x_next)."""
    one = np.float32(1.0)
    at, at_next = np.float32(at), np.float32(at_next)
    x0 = (x - eps * float(np.sqrt(one - at))) / float(np.sqrt(at))
    x_next = float(np.sqrt(at_next)) * x0 + float(np.float32(c2)) * eps
    if noise is not None:
        x_next = x_next + float(np.float32(c1)) * noise
    return x0, x_next
