"""Measurement scripts of the port (run on the card), and the model set-up
they and ``chip_smoke.py`` share."""

from __future__ import annotations

import torch


def snr_db(out, ref) -> float:
    """10·log10(mean(ref²) / mean((out − ref)²)) in float64."""
    ref = ref.double()
    err = ((out.double() - ref) ** 2).mean().clamp_min(1e-300)
    return float(10 * torch.log10((ref ** 2).mean() / err))


def audio_model(config_path: str = "configs/audio.yml", device="cuda",
                gn3_scale: float = 1.0):
    """(config, cfg, params): the audio.yml model (fp32 compute config) with
    seed-made weights on device. The final GroupNorm weights of every
    resblock are set to ``gn3_scale · (1 + 0.2·N(0, 1))``: at init they are
    zero, which makes every resblock the identity and hides conv errors
    (``gn3_scale=0`` keeps the init weights)."""
    from ..config import load_config
    from ..models.unet import ModelConfig, init_model

    config = load_config(config_path)
    cfg = ModelConfig.from_config(config)
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, cfg, device=device)
    if gn3_scale:
        for mod in ("down_modules", "up_modules"):
            for stage in params[mod]["stages"]:
                for block in stage["blocks"]:
                    g = block["norm3"]["g"]
                    noise = torch.randn(g.shape, generator=gen).to(g.device)
                    g.copy_(gn3_scale * (1.0 + 0.2 * noise))
    return config, cfg, params


def forward_input(cfg, device="cuda"):
    """(x [1, C, 8192, F] fp32, t [1]) from seed 1, the forward every script
    measures."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, cfg.channels, 8192, cfg.f_size), generator=gen)
    return x.to(device), torch.tensor([500], device=device)
