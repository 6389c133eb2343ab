"""Training losses (port of ``ddim_audio_tpu/training/losses.py``): the
simple ε-prediction DDPM loss, ``x_t = sqrt(a_t)·x0 + sqrt(1 − a_t)·e``,
squared error **summed over (C, T, F)** and averaged over the batch, keyed
by ``config.model.type``."""

from __future__ import annotations

import torch


def noise_estimation_loss(apply_fn, params, x0, t, e, alphas_cumprod, *,
                          keepdim: bool = False):
    """apply_fn(params, x, t) → ε-prediction; alphas_cumprod: [T] tensor."""
    a = alphas_cumprod[t][:, None, None, None].to(x0.dtype)
    x = x0 * torch.sqrt(a) + e * torch.sqrt(1.0 - a)
    out = apply_fn(params, x, t)
    per_sample = (e - out).square().sum(dim=(1, 2, 3))
    if keepdim:
        return per_sample
    return per_sample.mean(dim=0)


loss_registry = {
    "simple": noise_estimation_loss,
}
