"""The Diffusion runner, sampling side (port of
``ddim_audio_tpu/runners/diffusion_runner.py``).

``sample`` loads the evaluation weights from the run's checkpoint (EMA when
``model.ema``) and dispatches as the JAX runner does: ``--interpolation``,
``--sequence`` (kept x0 predictions per selected step) or
``sampling.last_only`` (the carry-only chain, final samples only). Every path
draws the start noise from the seed, runs the sampler on the unpadded flat
fp32 state through the flat-io denoiser under ``production_eval_cfg`` (only
the model call runs in the compute dtype), converts back to [N, C, T, F],
applies ``denoise_2d`` when ``sampling.denoise`` is set, and writes a PNG and
a WAV per sample. Training and ``test`` are later work (ROADMAP.md, queue A).
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
from ..utils.device import resolve_device
from ..weights import load_jax_checkpoint


def checkpoint_path(log_path: str, ckpt_id=None) -> str:
    """The checkpoint file a run loads: the rolling ``ckpt.npz`` by default,
    the step-tagged ``ckpt_<id>.npz`` when ``sampling.ckpt_id`` is set (the
    rule of the JAX package's ``checkpoint.checkpoint_path``)."""
    if ckpt_id is None:
        return os.path.join(log_path, "ckpt.npz")
    return os.path.join(log_path, f"ckpt_{ckpt_id}.npz")


class Diffusion:
    """args: namespace with seed, timesteps, skip_type, eta, sample_type,
    sequence, image_folder and log_path (the JAX CLI's names); config: the
    loaded YAML namespace; device: the card unless the caller asks for the
    CPU."""

    def __init__(self, args, config, device="cuda"):
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

    def _load_eval_params(self):
        """The evaluation weights from the run's checkpoint, written by the
        JAX package's ``checkpoint.save_checkpoint``: the EMA weights when
        ``model.ema``, else the raw ones."""
        config = self.config
        ckpt = checkpoint_path(self.args.log_path,
                               getattr(config.sampling, "ckpt_id", None))
        which = "ema" if config.model.ema else "params"
        params, meta = load_jax_checkpoint(ckpt, which, device=self.device)
        logging.info("loaded %s (step %d)", ckpt, meta["step"])
        return params

    def sample(self):
        args = self.args
        if getattr(args, "use_pretrained", False):
            raise ValueError("--use_pretrained supports no AUDIO checkpoints")
        params = self._load_eval_params()
        if getattr(args, "fid", False):
            self.sample_fid(params)
        elif getattr(args, "interpolation", False):
            self.sample_interpolation(params)
        elif getattr(args, "sequence", None) is not None:
            self.sample_sequence(params)
        elif getattr(self.config.sampling, "last_only", False):
            self.sample_last_only(params)
        else:
            raise NotImplementedError("Sample procedeure not defined")

    def sample_fid(self, params):
        if self.config.data.dataset == "AUDIO":
            raise NotImplementedError(
                "sample_fid with AUDIO dataset is not implemented")
        raise NotImplementedError("only the AUDIO dataset is supported")

    def sample_interpolation(self, params):
        """Slerp between two seed-drawn noises (alpha 0.0 … 1.0 step 0.1) →
        the final x0 prediction of each point as ``interp_XX.png/.wav``."""
        config = self.config
        gen = torch.Generator().manual_seed(int(self.args.seed))
        shape = (1, config.model.channels, config.sampling.t_size,
                 config.model.f_size)
        z1 = torch.randn(shape, generator=gen)
        z2 = torch.randn(shape, generator=gen)
        theta = torch.arccos((z1 * z2).sum()
                             / (torch.linalg.norm(z1) * torch.linalg.norm(z2)))
        alphas = np.arange(0.0, 1.01, 0.1, dtype=np.float32)
        zs = torch.cat([torch.sin((1 - float(a)) * theta) / torch.sin(theta) * z1
                        + torch.sin(float(a) * theta) / torch.sin(theta) * z2
                        for a in alphas], dim=0).to(self.device)
        _, x0_preds = self.sample_image(zs, params, select_index=[-1])
        out = self._postprocess(x0_preds[-1])  # [11, C, T, F]
        self.export(out, [f"interp_{i:02d}" for i in range(len(out))])
        logging.info("wrote %d interpolation points to %s", len(out),
                     self.args.image_folder)

    def sample_sequence(self, params):
        """Write the x0 prediction of every selected step as
        ``{sample}_{step}.png/.wav`` (like the reference, the saved images
        are the per-step predicted x0, not x_{t-1})."""
        args = self.args
        x = self.start_noise()
        if args.sequence in (-1, 0):
            # keep every step: select_index=range(timesteps) would drop the
            # tail when the uniform subsequence overshoots the request
            select_index = None
        else:
            idx = np.linspace(1, args.timesteps, args.sequence, dtype=np.int32)
            select_index = set((args.timesteps - idx).tolist())
        self.timings = {}
        _, x0_preds = self.sample_image(x, params, select_index=select_index,
                                        timings=self.timings)
        logging.info("sampler: compute %.3f s, drain %.3f s, %d mid-run "
                     "drains", self.timings["compute_s"],
                     self.timings["drain_s"], self.timings["mid_drains"])
        digits = int(np.ceil(np.log10(len(x0_preds) + 1)))
        for i, pred in enumerate(x0_preds):
            out = self._postprocess(pred)
            self.export(out, [f"{j}_{i:0{digits}d}" for j in range(len(out))])
        logging.info("wrote %d sample steps to %s", len(x0_preds),
                     args.image_folder)

    def sample_image(self, x, params, select_index=None, timings=None):
        """Timestep subsequence + sampler dispatch: (xs, x0_preds) host
        arrays [B, C, T, F]. Kept states travel in ``sampling.buffer_dtype``
        (default float16; exports are 8-bit PNG / PCM WAV, far below fp16
        noise — set float32 for bit-exact kept states)."""
        args = self.args
        seq = make_timestep_subsequence(self.num_timesteps, args.timesteps,
                                        args.skip_type)
        sampler, x_state, _ = self._sampler_for_state(x)
        gen = torch.Generator().manual_seed(int(args.seed) + 1)
        return sampler.sample(
            x_state, seq, self.schedule, eta=args.eta,
            select_index=select_index, generator=gen,
            params=prepare_params(params, self.eval_cfg),  # once per run
            buffer_dtype=getattr(self.config.sampling, "buffer_dtype",
                                 "float16") or "float16",
            timings=timings)

    def _postprocess(self, out: np.ndarray) -> np.ndarray:
        if self.config.sampling.denoise:
            out = denoise_2d(torch.from_numpy(out).to(self.device)).cpu().numpy()
        return out

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
        params = prepare_params(params, self.eval_cfg)  # once per run
        out = sampler.sample_last(x_state, seq, self.schedule, eta=args.eta,
                                  generator=gen, params=params)
        out = finalize(out)
        if config.sampling.denoise:
            out = denoise_2d(out)
        out = out.cpu().numpy()
        self.export(out, [f"{j}_final" for j in range(len(out))])
        logging.info("wrote %d final samples to %s", len(out),
                     args.image_folder)
        return out

    def export(self, out: np.ndarray, names) -> None:
        """Write {name}.png and {name}.wav into args.image_folder for each
        sample of out [N, C, T, F]."""
        from PIL import Image
        from scipy.io.wavfile import write as wav_write

        config = self.config
        os.makedirs(self.args.image_folder, exist_ok=True)
        for name, img in zip(names, out.transpose(0, 3, 2, 1)):  # → [F, T, C]
            path = os.path.join(self.args.image_folder, name)
            Image.fromarray(limit_length_img(pfft2img(img))).save(path + ".png")
            wav = pfft2wav(img, config.sampling.virtual_samplerate,
                           dtype=np.int32, HPI=config.sampling.HPI)
            wav_write(path + ".wav",
                      config.data.dataset_kwargs.virtual_samplerate, wav)

    def _sampler_for_state(self, x):
        """(sampler, x_state, finalize) for a start noise x [B, C, T, F].

        The sampler carries the unpadded flat fp32 state [B, T, F·C] across
        steps and runs the kernel forward (``apply_model_flat_io``); kept
        states convert back to [B, C, T, F] before they are buffered; noise
        is drawn channel-shaped then reshaped, as the JAX package's flat-io
        adapters."""
        cfg = self.eval_cfg
        kind = getattr(self.args, "sample_type", "generalized")
        scan_chunk = int(getattr(self.config.sampling, "scan_chunk", 100))
        to_flat, from_flat = flat_io_adapters(cfg)

        def flat(params, xf, t):
            return apply_model_flat_io(params, xf, t, cfg)

        def noise_builder(gen, xf):
            b, t, _ = xf.shape
            n = torch.randn((b, cfg.channels, t, cfg.f_size), generator=gen)
            return to_flat(n.to(xf.device))

        sampler = ScanSampler(flat, kind=kind, scan_chunk=scan_chunk,
                              state_to_saved=from_flat,
                              noise_builder=noise_builder)
        return sampler, to_flat(x).contiguous(), from_flat
