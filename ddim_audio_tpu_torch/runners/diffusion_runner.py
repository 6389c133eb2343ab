"""The Diffusion runner, sampling side (port of
``ddim_audio_tpu/runners/diffusion_runner.py``: ``sample_last_only`` and
``_sampler_for_state``).

``sample_last_only`` draws the start noise from the seed, runs the DDIM
last-only chain through the flat-io denoiser (the fp32 flat state is the
carry; only the model call runs in the compute dtype), converts back to
[N, C, T, F], applies ``denoise_2d`` when ``sampling.denoise`` is set, and
writes ``{j}_final.png`` and ``{j}_final.wav`` per sample. Training, the
kept-state ``--sequence`` path, DDPM and the CLI are later work (ROADMAP.md,
queue A).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..config import production_eval_cfg
from ..data.codec import limit_length_img, pfft2img, pfft2wav
from ..diffusion.schedules import make_schedule, make_timestep_subsequence
from ..models.unet import (
    ModelConfig,
    apply_model_flat_io,
    flat_io_adapters,
    prepare_params,
)
from ..ops.signal import denoise_2d
from ..sampling.driver import ScanSampler


def resolve_device(device) -> torch.device:
    """torch.device for a name; asking for CUDA without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA GPU is "
                           "available")
    return device


class Diffusion:
    """args: namespace with seed, timesteps, skip_type, eta, sample_type and
    image_folder (the JAX CLI's names); config: the loaded YAML namespace."""

    def __init__(self, args, config, device="cpu"):
        self.args = args
        self.config = config
        self.device = resolve_device(device)
        self.model_cfg = ModelConfig.from_config(config)
        self.eval_cfg = production_eval_cfg(config, self.model_cfg)
        self.schedule = make_schedule(
            config.diffusion.beta_schedule,
            config.diffusion.beta_start,
            config.diffusion.beta_end,
            config.diffusion.num_diffusion_timesteps,
        )
        self.num_timesteps = self.schedule.num_timesteps

    def start_noise(self) -> torch.Tensor:
        """x_T [num_samples, C, T, F] fp32 from args.seed (drawn on the CPU,
        so it is the same numbers on every device)."""
        config = self.config
        gen = torch.Generator().manual_seed(int(self.args.seed))
        shape = (config.sampling.num_samples, config.model.channels,
                 config.sampling.t_size, config.model.f_size)
        return torch.randn(shape, generator=gen).to(self.device)

    def sample_last_only(self, params, x=None):
        """Run the whole subsequence through the carry-only loop and export
        only the final samples. Returns the exported [N, C, T, F] array."""
        args, config = self.args, self.config
        if x is None:
            x = self.start_noise()
        seq = make_timestep_subsequence(self.num_timesteps, args.timesteps,
                                        args.skip_type)
        sampler, x_state, finalize = self._sampler_for_state(x)
        gen = torch.Generator().manual_seed(int(args.seed) + 1)
        params = prepare_params(params, self.eval_cfg.dtype)  # once per run
        out = sampler.sample_last(x_state, seq, self.schedule, eta=args.eta,
                                  generator=gen, params=params)
        out = finalize(out)
        if config.sampling.denoise:
            out = denoise_2d(out)
        out = out.cpu().numpy()
        self.export(out, "final")
        return out

    def export(self, out: np.ndarray, tag: str) -> None:
        """Write {j}_{tag}.png and {j}_{tag}.wav for each sample of
        out [N, C, T, F]."""
        from PIL import Image
        from scipy.io.wavfile import write as wav_write

        config = self.config
        os.makedirs(self.args.image_folder, exist_ok=True)
        for j, img in enumerate(out.transpose(0, 3, 2, 1)):  # → [F, T, C]
            path = os.path.join(self.args.image_folder, f"{j}_{tag}")
            Image.fromarray(limit_length_img(pfft2img(img))).save(path + ".png")
            wav = pfft2wav(img, config.sampling.virtual_samplerate,
                           dtype=np.int32, HPI=config.sampling.HPI)
            wav_write(path + ".wav",
                      config.data.dataset_kwargs.virtual_samplerate, wav)
        logging.info("wrote %d %s samples to %s", len(out), tag,
                     self.args.image_folder)

    def _sampler_for_state(self, x):
        """(sampler, x_state, finalize) for a start noise x [B, C, T, F].

        The sampler carries the unpadded flat fp32 state [B, T, F·C] across
        steps and runs the kernel forward (``apply_model_flat_io``); eta > 0
        noise is drawn channel-shaped then reshaped, as the JAX package's
        flat-io adapters."""
        cfg = self.eval_cfg
        kind = getattr(self.args, "sample_type", "generalized")
        to_flat, from_flat = flat_io_adapters(cfg)

        def flat(params, xf, t):
            return apply_model_flat_io(params, xf, t, cfg)

        def noise_builder(gen, xf):
            b, t, _ = xf.shape
            n = torch.randn((b, cfg.channels, t, cfg.f_size), generator=gen)
            return to_flat(n.to(xf.device))

        sampler = ScanSampler(flat, kind=kind, noise_builder=noise_builder)
        return sampler, to_flat(x).contiguous(), from_flat
