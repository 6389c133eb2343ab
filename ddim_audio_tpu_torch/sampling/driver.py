"""Sampler driver (port of ``ddim_audio_tpu/sampling/driver.py``, the
last-only DDIM path).

``ScanSampler.sample_last`` is the JAX package's scan over precomputed
per-step coefficients written as a Python loop: the carry is the state x
(fp32), the model call is the only per-step device work, and nothing is
fetched to the host until the end. Kept-state trajectories (``sample``),
DDPM and CUDA-graph capture of the loop are later work (ROADMAP.md, queue A).
"""

from __future__ import annotations

import torch

from .ddim import ddim_coefficients, ddim_step


class ScanSampler:
    """DDIM ("generalized") sampling with a denoiser
    ``denoise_fn(params, x, t int64 [B]) -> eps`` in x's layout.

    noise_builder: optional ``fn(generator, x) -> noise`` for eta > 0 (the
    flat state draws channel-shaped noise and reshapes it, as the JAX
    package's flat-io adapters)."""

    def __init__(self, denoise_fn, *, kind: str = "generalized",
                 noise_builder=None):
        if kind != "generalized":
            raise NotImplementedError(
                f"sample_type {kind!r}: the port has only the DDIM "
                "('generalized') sampler so far (DDPM is ROADMAP.md queue A)")
        self.denoise_fn = denoise_fn
        self.noise_builder = noise_builder

    def sample_last(self, x, seq, schedule, *, eta: float = 0.0,
                    generator: torch.Generator | None = None, params=None):
        """Run the whole reversed subsequence and return only the final x
        (same dtype and device as x)."""
        coeffs = ddim_coefficients(schedule.alphas_cumprod, seq, eta)
        with_noise = eta != 0.0
        if with_noise and generator is None:
            generator = torch.Generator().manual_seed(0)
        b = x.shape[0]
        for k in range(len(coeffs["t"])):
            t = torch.full((b,), int(coeffs["t"][k]), dtype=torch.long,
                           device=x.device)
            eps = self.denoise_fn(params, x, t)
            noise = None
            if with_noise:
                if self.noise_builder is not None:
                    noise = self.noise_builder(generator, x)
                else:
                    noise = torch.randn(x.shape, generator=generator,
                                        dtype=x.dtype).to(x.device)
            _, x_next = ddim_step(x, eps, coeffs["at"][k],
                                  coeffs["at_next"][k], coeffs["c1"][k],
                                  coeffs["c2"][k], noise)
            # fp32 update math; only the stored carry takes x's dtype
            x = x_next.to(x.dtype)
        return x
