"""Timestep embeddings.

``beta_embedding_*`` (the U-Net's; port of
``ddim_audio_tpu/models/embeddings.py``): a fixed interleaved sin/cos table
[num_timesteps, 128] gathered by t (indices clipped into the table, as the
JAX package's ``mode="clip"``), then the MLP 128 → 512 → 512 → Σ(embedding
sizes) with SiLU between layers.

``timestep_sinusoid`` (the SD UNet's): diffusers' ``Timesteps``, halves of
sin and cos rather than interleaved, with its ``flip_sin_to_cos`` and
``freq_shift``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import linear_apply, linear_init, sinusoid_on

POS_CH = 128
EMB_CH = 512


def beta_embedding_init(gen, num_timesteps: int, channel_sz: int, device):
    del num_timesteps  # the table is a constant, not a parameter
    return {
        "mlp": [
            linear_init(gen, POS_CH, EMB_CH, device=device),
            linear_init(gen, EMB_CH, EMB_CH, device=device),
            linear_init(gen, EMB_CH, channel_sz, device=device),
        ]
    }


def beta_embedding_apply(params, t, *, num_timesteps: int):
    """t: int tensor [B] → fp32 [B, channel_sz]."""
    device = params["mlp"][0]["w"].device
    table = sinusoid_on(num_timesteps, POS_CH, device, torch.float32)
    idx = torch.as_tensor(t, device=device).long().clamp(0, num_timesteps - 1)
    x = table[idx]
    x = F.silu(linear_apply(params["mlp"][0], x))
    x = F.silu(linear_apply(params["mlp"][1], x))
    return linear_apply(params["mlp"][2], x)


def timestep_sinusoid(t, dim: int, *, flip_sin_to_cos: bool,
                      freq_shift: float, max_period: float = 10000.0):
    """t [B] → fp32 [B, dim], as diffusers' ``get_timestep_embedding``:
    with h = dim // 2 and f_k = exp(−ln(max_period)·k / (h − freq_shift)),
    [sin(t·f), cos(t·f)] over k < h, the halves swapped when
    ``flip_sin_to_cos``, a zero column appended when dim is odd."""
    half = dim // 2
    k = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * k / (half - freq_shift))
    arg = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb
