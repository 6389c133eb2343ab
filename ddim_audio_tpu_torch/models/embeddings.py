"""Timestep ("beta") embedding (port of ``ddim_audio_tpu/models/embeddings.py``).

A fixed interleaved sin/cos table [num_timesteps, 128] gathered by t (indices
clipped into the table, as the JAX package's ``mode="clip"``), then the MLP
128 → 512 → 512 → Σ(embedding sizes) with SiLU between layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import linear_apply, linear_init, sinusoid_on

POS_CH = 128
EMB_CH = 512


def beta_embedding_init(gen, num_timesteps: int, channel_sz: int, device="cpu"):
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
