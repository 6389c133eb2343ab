"""Post-hoc 2-D spectrogram denoising (port of ``ddim_audio_tpu/ops/signal.py``).

A local adaptive Wiener filter over the (T, F) plane (``sampling.denoise``):

    m   = local mean (k×k box, edge padding)
    v   = local variance
    σ²  = mean(v)                    (noise power estimate)
    out = m + max(v−σ², 0) / max(v, σ², 1e-20) · (x − m)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _box_filter_2d(x, k: int):
    """Mean filter over the last two axes with edge padding (cumulative-sum
    form, as the JAX package)."""
    pad = k // 2
    lead = x.shape[:-2]
    t, f = x.shape[-2], x.shape[-1]
    xp = F.pad(x.reshape(-1, 1, t, f), (pad, pad, pad, pad), mode="replicate")
    c = torch.cumsum(torch.cumsum(xp, dim=-1), dim=-2)
    c = F.pad(c, (1, 0, 1, 0))
    s = (c[..., k:k + t, k:k + f] - c[..., :t, k:k + f]
         - c[..., k:k + t, :f] + c[..., :t, :f])
    return (s / (k * k)).reshape(*lead, t, f)


def denoise_2d(x, kernel_size: int = 5):
    """x [..., T, F] → denoised x (adaptive Wiener over the T-F plane)."""
    m = _box_filter_2d(x, kernel_size)
    v = (_box_filter_2d(x * x, kernel_size) - m * m).clamp_min(0.0)
    sigma2 = v.mean(dim=(-2, -1), keepdim=True)
    gain = (v - sigma2).clamp_min(0.0) / torch.maximum(v, sigma2).clamp_min(1e-20)
    return m + gain * (x - m)
