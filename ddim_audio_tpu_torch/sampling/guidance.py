"""Classifier-free guidance as a ``ScanSampler`` denoiser.

Each step runs the conditional denoiser once on the doubled batch [x; x]
under [unconditional; text] embeddings and combines its two halves,

    ε = ε_u + g · (ε_c − ε_u),

in fp32, as diffusers' Stable Diffusion pipelines do. The embeddings travel
in the sampler's params tree, ``{"unet": <the denoiser's params>, "cond":
guidance_rows(...)}``, made once a run, so ``ScanSampler`` itself does not
change.
"""

from __future__ import annotations

import torch

from ..utils.tracing import span


def guidance_rows(text, uncond, dtype=None) -> torch.Tensor:
    """The embeddings of the doubled batch: the unconditional [tokens, dim]
    once for each of the N rows of text [N, tokens, dim], then the text."""
    rows = torch.cat([uncond.expand(text.shape[0], *uncond.shape), text])
    return rows if dtype is None else rows.to(dtype)


def guided_denoiser(apply_fn, scale: float):
    """``denoise_fn(params, x, t) -> ε`` (fp32) of the conditional denoiser
    ``apply_fn(unet_params, x, t, cond)`` under guidance ``scale``."""
    scale = float(scale)

    def denoise(params, x, t):
        with span("ddim.sampler.guidance"):
            eps = apply_fn(params["unet"], torch.cat([x, x]),
                           torch.cat([t, t]), params["cond"]).float()
            eps_u, eps_c = eps.chunk(2)
            return eps_u + scale * (eps_c - eps_u)

    return denoise
