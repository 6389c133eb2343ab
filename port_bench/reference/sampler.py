"""DDIM sampling (eta 0) and the post-hoc spectrogram filter in plain
PyTorch float32, written from their equations.

Schedule: betas linear from beta_start to beta_end over T steps (float64),
ᾱ_t = Π_{s<=t} (1 − β_s), taken as float32. The uniform subsequence is
0, k, 2k, … with k = T // steps, walked from the top; with a = ᾱ_t and
a' = ᾱ of the next lower timestep (1 after the last):

    x0     = (x − sqrt(1 − a)·ε) / sqrt(a)
    x_next = sqrt(a')·x0 + sqrt(1 − a')·ε

The filter is a local adaptive Wiener filter over each (T, F) plane: with
m and v the mean and variance over a 5×5 box (edges replicated) and σ² the
mean of v, out = m + max(v − σ², 0) / max(v, σ², 1e-20) · (x − m).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def alphas_cumprod(diffusion: dict) -> np.ndarray:
    if diffusion["beta_schedule"] != "linear":
        raise ValueError("the reference has the linear schedule only")
    betas = np.linspace(diffusion["beta_start"], diffusion["beta_end"],
                        diffusion["num_diffusion_timesteps"], dtype=np.float64)
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_plan(abar: np.ndarray, steps: int) -> list:
    """[(t, sqrt(1 − a)/sqrt(a) terms…)] from the top: (t, a, a_next)."""
    n = len(abar)
    seq = list(range(0, n, n // steps))
    plan = []
    for i, t in enumerate(reversed(seq)):
        nxt = seq[len(seq) - 2 - i] if i < len(seq) - 1 else None
        plan.append((t, float(abar[t]),
                     1.0 if nxt is None else float(abar[nxt])))
    return plan


@torch.no_grad()
def ddim_chain(model, params, x, abar, steps: int):
    """x_T [B, C, T, F] float32 → x_0 after the DDIM (eta 0) walk."""
    for t, a, a_next in ddim_plan(abar, steps):
        tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps = model(params, x, tt)
        x0 = (x - eps * np.sqrt(1.0 - a)) / np.sqrt(a)
        x = np.sqrt(a_next) * x0 + np.sqrt(1.0 - a_next) * eps
    return x


def _box_mean(x, k: int):
    b = x.shape[:-2]
    t, f = x.shape[-2:]
    xp = F.pad(x.reshape(-1, 1, t, f), (k // 2,) * 4, mode="replicate")
    return F.avg_pool2d(xp, k, stride=1).reshape(*b, t, f)


def wiener_2d(x, k: int = 5):
    """The adaptive Wiener filter over the last two axes."""
    m = _box_mean(x, k)
    v = (_box_mean(x * x, k) - m * m).clamp_min(0.0)
    s2 = v.mean(dim=(-2, -1), keepdim=True)
    gain = (v - s2).clamp_min(0.0) / torch.maximum(v, s2).clamp_min(1e-20)
    return m + gain * (x - m)
