"""The Diffusion runner: train / sample / test (port of
``ddim_audio_tpu/runners/diffusion_runner.py``).

``train`` builds the dataset and its deterministic split, the model, the
per-group optimizers and the EMA, resumes from the rolling checkpoint when
asked, and loops over ``training.train_step``: the loop never synchronises
with the device; metrics are read in batches of 16 (or at a snapshot),
snapshots are written at step 1 and every ``snapshot_freq`` steps, a bounded
validation pass on the held-out split runs every ``validation_freq`` steps
with the EMA weights, and any exception leaves an emergency snapshot before
it propagates. ``test`` is the mean ε-loss over the held-out split.

``sample`` loads the evaluation weights from the run's checkpoint (EMA when
``model.ema``) and dispatches as the JAX runner does: ``--interpolation``,
``--sequence`` (kept x0 predictions per selected step) or
``sampling.last_only`` (the carry-only chain, final samples only). Every path
draws the start noise from the seed, runs the sampler under
``production_eval_cfg`` (only the model call runs in the compute dtype) on
the unpadded flat fp32 state through the flat-io denoiser, or, where
``models.unet.flat_route`` refuses the model (``conv_impl: xla``, a stage
with other than 3×3 convs), on [B, C, T, F] through ``apply_model`` as the
JAX runner falls back, converts back to [N, C, T, F],
applies ``denoise_2d`` when ``sampling.denoise`` is set, and writes a PNG and
a WAV per sample.

``config.parallel`` {dp, sp} lays the ranks of the process group out as a
mesh (``parallel/mesh.py``; more than one device needs a launcher's ranks, a
plain process has one). Every rank draws the whole start noise (and the
per-step noise) from the seed and keeps its block: its slice of the batch on
dp, and on sp its time block too, which the sampler carries in [B, C, T, F]
through the sequence-parallel forward (``parallel/sp.py``). The ranks'
results are gathered, so a mesh run's clips are a single-device run's, and
rank 0 alone writes files. Training hands every rank the whole batch:
``make_train_step(mesh=)`` keeps its share of the microbatches on dp and its
time block on sp, and adds the ranks' gradients; validation and ``test``
run whole on every rank.

``model.type: sd_unet`` (``configs/riffusion_sd15.yml``) runs the Stable
Diffusion v1.5 UNet (``models/sd_unet.py``) instead, on one device and for
``sampling.last_only`` chains alone: start noise [num_samples, 4, 64, 64],
classifier-free guidance at ``sampling.guidance_scale`` on a doubled batch
(``sampling/guidance.py``), each final latent written as ``{name}.npy``.
The text embeddings stand in for the CLIP text encoder's, which the
repository does not have; the chain ends at the latent (no VAE decoder).
``--sequence``, ``--interpolation``, ``--fid``, ``--test`` and training
raise at once. Any other ``model.type`` is the U-Net + FNet.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..checkpoint import checkpoint_path, load_checkpoint, save_checkpoint
from ..config import production_eval_cfg
from ..data.audio_dataset import batch_iterator, get_dataset
from ..data.codec import limit_length_img, pfft2img, pfft2wav
from ..diffusion.schedules import make_schedule, make_timestep_subsequence
from ..models import sd_unet
from ..models.unet import (
    ModelConfig,
    apply_model,
    apply_model_flat_io,
    count_params,
    flat_io_adapters,
    flat_route,
    init_model,
    prepare_params,
)
from ..ops.signal import denoise_2d
from ..parallel.mesh import gather_batch, make_mesh, shard_batch, world_rank
from ..parallel.sp import (
    apply_model_sp_local,
    check_sp_time,
    sp_sampling_bundle,
)
from ..sampling.driver import ScanSampler
from ..sampling.guidance import guidance_rows, guided_denoiser
from ..training.losses import loss_registry
from ..training.train_step import init_train_state, make_train_step
from ..utils.device import resolve_device
from ..utils.tracing import span
from ..weights import load_jax_checkpoint

_SEED_STRIDE = 1_000_003  # spreads (seed, step) over generator seeds


def _device_prefetch(host_iter, device):
    """Yield device batches one transfer ahead: batch i+1 is staged in pinned
    host memory and its copy enqueued (non-blocking) before batch i's train
    step is issued, so the feed rides under the step's compute. Depth 1
    bounds the extra device memory to one batch."""
    def to_device(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    nxt = None
    for x, _ in host_iter:
        cur, nxt = nxt, to_device(x)
        if cur is not None:
            yield cur
    if nxt is not None:
        yield nxt


class Diffusion:
    """args: namespace with seed, timesteps, skip_type, eta, sample_type,
    sequence, image_folder and log_path (the JAX CLI's names); config: the
    loaded YAML namespace; device: the card unless the caller asks for the
    CPU (under a process group, the device this rank drives)."""

    def __init__(self, args, config, device="cuda"):
        self.mesh = make_mesh(getattr(config, "parallel", None))
        self.is_writer = world_rank() == 0
        self.args = args
        self.config = config
        self.device = resolve_device(device)
        self.sd = getattr(config.model, "type", None) == sd_unet.MODEL_TYPE
        if self.sd:
            if self.mesh is not None:
                raise ValueError("the sd_unet model runs on one device: set "
                                 "parallel.dp and parallel.sp to 1")
            self.model_cfg = sd_unet.SDUNetConfig.from_config(config)
        else:
            self.model_cfg = ModelConfig.from_config(config)
        self.eval_cfg = production_eval_cfg(config, self.model_cfg)
        self.schedule = make_schedule(
            config.diffusion.beta_schedule,
            config.diffusion.beta_start,
            config.diffusion.beta_end,
            config.diffusion.num_diffusion_timesteps,
        )
        self.num_timesteps = self.schedule.num_timesteps

    def _refuse_sd(self, mode: str) -> None:
        """Raise where the SD UNet has no such mode."""
        if self.sd:
            raise NotImplementedError(
                f"{mode} is not supported for model.type sd_unet: it "
                f"samples sampling.last_only chains only")

    # ------------------------------------------------------------------ train

    def _eval_loss_fn(self, params):
        """loss(x0, t, e) of the eval forward in the model's own dtype (the
        flat kernel route, or ``apply_model`` where ``flat_route`` refuses
        the model) for a parameter tree, without gradients."""
        cfg = self.model_cfg
        to_flat, from_flat = flat_io_adapters(cfg)
        prepared = prepare_params(params, cfg)
        alphas = torch.as_tensor(self.schedule.alphas_cumprod,
                                 dtype=torch.float32, device=self.device)
        loss_impl = loss_registry[self.config.model.type]

        def apply_fn(p, x, t):
            if not flat_route(cfg):
                return apply_model(p, x, t, cfg)
            return from_flat(apply_model_flat_io(p, to_flat(x).contiguous(),
                                                 t, cfg))

        @torch.no_grad()
        def loss(x0, t, e):
            return loss_impl(apply_fn, prepared, x0, t, e, alphas)

        return loss

    def _heldout_losses(self, test_dataset, params, rng, max_batches=None):
        """ε-loss of each held-out batch (at most max_batches), with numpy
        timesteps and seeded noise drawn from ``rng``."""
        loss_fn = self._eval_loss_fn(params)
        losses = []
        for bi, (vx, _) in enumerate(batch_iterator(
                test_dataset, self.config.training.batch_size,
                shuffle=False)):
            if max_batches is not None and bi >= max_batches:
                break
            t = torch.from_numpy(rng.integers(
                0, self.num_timesteps, size=(vx.shape[0],))).to(self.device)
            gen = torch.Generator(self.device).manual_seed(
                int(rng.integers(1 << 31)))
            e = torch.randn(vx.shape, generator=gen, device=self.device)
            losses.append(float(loss_fn(
                torch.from_numpy(vx).to(self.device), t, e)))
        return losses

    def train(self):
        self._refuse_sd("training")
        args, config = self.args, self.config
        if (config.training.n_epochs is not None) == (
                config.training.n_iters is not None):
            raise ValueError("set exactly one of training.n_epochs and "
                             "training.n_iters")
        dataset, test_dataset = get_dataset(args, config)
        logging.info("dataset: %d train / %d test items", len(dataset),
                     len(test_dataset))

        params = init_model(torch.Generator().manual_seed(int(args.seed)),
                            self.model_cfg, device=self.device)
        logging.info("model params: %d", count_params(params))
        state, tx = init_train_state(params, config.optimization,
                                     use_ema=bool(config.model.ema))
        train_step = make_train_step(self.model_cfg, config,
                                     self.schedule.alphas_cumprod, tx,
                                     mesh=self.mesh)

        start_epoch, step = 0, 0
        if getattr(args, "resume_training", False):
            state, meta = load_checkpoint(
                os.path.join(args.log_path, "ckpt.npz"), state)
            start_epoch, step = meta["epoch"], meta["step"]
            logging.info("resumed from step %d (epoch %d)", step, start_epoch)

        # one generator, re-seeded from (seed, step) before every step: the
        # draws of step k do not depend on where a run started, nor on the
        # rank (each rank reads the whole batch and keeps its slice)
        generator = torch.Generator(self.device)
        tb = getattr(config, "tb_logger", None)
        log_freq = int(getattr(config.training, "log_freq", 1))
        snapshot_freq = config.training.snapshot_freq
        validation_freq = getattr(config.training, "validation_freq", None)
        val_batches = int(getattr(config.training, "validation_batches", 2)
                          or 2)
        pending = []  # (step, device metrics), read lazily

        def run_validation(step):
            losses = self._heldout_losses(
                test_dataset, state.ema if config.model.ema else state.params,
                np.random.default_rng(args.seed + step), val_batches)
            val = float(np.mean(losses)) if losses else float("nan")
            if tb is not None:
                tb.add_scalar("val_loss", val, global_step=step)
            logging.info("step: %d, val-loss: %.4f", step, val)

        def flush_metrics():
            for s, m in pending:
                host = {k: float(v) for k, v in m.items()}
                if tb is not None:
                    tb.add_scalar("loss", host["loss"], global_step=s)
                logging.info(", ".join(
                    [f"step: {s}"] + [f"{k}: {v:.4f}" for k, v in host.items()]))
            pending.clear()

        def run_step(x, epoch, step):
            nonlocal state
            generator.manual_seed(int(args.seed) * _SEED_STRIDE + step - 1)
            state, metrics = train_step(state, x, generator)
            if step % log_freq == 0:
                pending.append((step, metrics))
            if len(pending) >= 16:
                flush_metrics()
            if step % snapshot_freq == 0 or step == 1:
                flush_metrics()
                save_checkpoint(args.log_path, state, step, epoch=epoch)
            if validation_freq and step % int(validation_freq) == 0:
                flush_metrics()
                run_validation(step)

        def batches(epoch):
            num_workers = int(getattr(config.data, "num_workers", 0) or 0)
            return _device_prefetch(batch_iterator(
                dataset, config.training.batch_size, shuffle=True,
                seed=args.seed + epoch, num_workers=num_workers), self.device)

        epoch = start_epoch
        try:
            if config.training.n_epochs is not None:
                for epoch in range(start_epoch, config.training.n_epochs):
                    for x in batches(epoch):
                        step += 1
                        run_step(x, epoch, step)
            else:
                while step < config.training.n_iters:
                    for x in batches(epoch):
                        step += 1
                        run_step(x, epoch, step)
                        if step >= config.training.n_iters:
                            break
                    epoch += 1
        except BaseException:
            # keep the progress since the last snapshot, then propagate
            try:
                path = save_checkpoint(args.log_path, state, step,
                                       epoch=epoch, tag="emergency")
                logging.error("training interrupted; emergency snapshot: %s",
                              path)
            except Exception:
                logging.exception("emergency snapshot failed")
            raise
        flush_metrics()
        save_checkpoint(args.log_path, state, step, epoch=epoch)

    # ------------------------------------------------------------------- test

    def test(self):
        """Mean validation ε-loss over the held-out split."""
        self._refuse_sd("--test")
        args, config = self.args, self.config
        _, test_dataset = get_dataset(args, config)
        t0 = time.time()
        losses = self._heldout_losses(test_dataset, self._load_eval_params(),
                                      np.random.default_rng(args.seed))
        mean = float(np.mean(losses)) if losses else float("nan")
        logging.info("test: mean eps-loss %.4f over %d batches (%.1fs)", mean,
                     len(losses), time.time() - t0)
        return mean

    # ----------------------------------------------------------------- sample

    def start_noise(self) -> torch.Tensor:
        """x_T [num_samples, C, T, F] (the SD UNet's [num_samples, 4, 64,
        64]) fp32 from args.seed (drawn on the CPU, so it is the same numbers
        on every device and every rank)."""
        config = self.config
        gen = torch.Generator().manual_seed(int(self.args.seed))
        if self.sd:
            cfg = self.model_cfg
            shape = (config.sampling.num_samples, cfg.in_channels,
                     cfg.sample_size, cfg.sample_size)
        else:
            shape = (config.sampling.num_samples, config.model.channels,
                     config.sampling.t_size, config.model.f_size)
        return torch.randn(shape, generator=gen).to(self.device)

    def draw_conditioning(self, n: int):
        """(text [n, tokens, dim], uncond [tokens, dim]) fp32 drawn from
        args.seed: seed-made stand-ins for the CLIP text encoder's
        embeddings of n prompts and of the empty prompt."""
        cfg = self.model_cfg
        gen = torch.Generator().manual_seed(int(self.args.seed) + 2)
        shape = (cfg.text_tokens, cfg.cross_attention_dim)
        text = torch.randn((n, *shape), generator=gen)
        uncond = torch.randn(shape, generator=gen)
        return text.to(self.device), uncond.to(self.device)

    def _load_eval_params(self):
        """The evaluation weights from the run's checkpoint (written by
        ``checkpoint.save_checkpoint`` of either package): the EMA weights
        when ``model.ema``, else the raw ones."""
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
        for flag, mode in (("fid", "--fid"),
                           ("interpolation", "--interpolation")):
            if getattr(args, flag, False):
                self._refuse_sd(mode)
        if getattr(args, "sequence", None) is not None:
            self._refuse_sd("--sequence")
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
            params=self._sampler_params(params, x),  # once per run
            buffer_dtype=getattr(self.config.sampling, "buffer_dtype",
                                 "float16") or "float16",
            timings=timings)

    def _postprocess(self, out: np.ndarray) -> np.ndarray:
        if self.config.sampling.denoise:
            with span("ddim.runner.filter"):
                out = denoise_2d(torch.from_numpy(out).to(self.device))
            out = out.cpu().numpy()
        return out

    def sample_last_only(self, params, x=None, cond=None):
        """Run the whole subsequence through the carry-only loop and export
        only the final samples. Returns the exported [N, C, T, F] array.
        The SD UNet takes cond = (text [N, tokens, dim], uncond [tokens,
        dim]), the embeddings of the N prompts and of the empty prompt, or
        draws both from args.seed (``draw_conditioning``) where cond is
        None."""
        args, config = self.args, self.config
        with span("ddim.runner.chain"):
            if x is None:
                x = self.start_noise()
            seq = make_timestep_subsequence(self.num_timesteps,
                                            args.timesteps, args.skip_type)
            sampler, x_state, finalize = self._sampler_for_state(x)
            gen = torch.Generator().manual_seed(int(args.seed) + 1)
            out = sampler.sample_last(x_state, seq, self.schedule,
                                      eta=args.eta, generator=gen,
                                      params=self._sampler_params(params, x,
                                                                  cond))
            with span("ddim.runner.finalize"):
                out = finalize(out)
            if config.sampling.denoise:
                with span("ddim.runner.filter"):
                    out = denoise_2d(out)
            with span("ddim.runner.to_host"):
                out = out.cpu().numpy()
            self.export(out, [f"{j}_final" for j in range(len(out))])
            logging.info("wrote %d final samples to %s", len(out),
                         args.image_folder)
        return out

    def export(self, out: np.ndarray, names) -> None:
        """Write {name}.png and {name}.wav into args.image_folder for each
        sample of out [N, C, T, F] (rank 0 only); the SD UNet's latents as
        {name}.npy."""
        if not self.is_writer:
            return
        with span("ddim.runner.export"):
            if self.sd:
                os.makedirs(self.args.image_folder, exist_ok=True)
                for name, latent in zip(names, out):
                    with span("ddim.runner.export.clip"):
                        np.save(os.path.join(self.args.image_folder,
                                             name + ".npy"), latent)
                return
            from PIL import Image
            from scipy.io.wavfile import write as wav_write

            config = self.config
            os.makedirs(self.args.image_folder, exist_ok=True)
            rate = config.data.dataset_kwargs.virtual_samplerate
            clips = out.transpose(0, 3, 2, 1)  # → [N, F, T, C]
            for name, img in zip(names, clips):
                path = os.path.join(self.args.image_folder, name)
                with span("ddim.runner.export.clip"):
                    with span("ddim.runner.export.png"):
                        png = Image.fromarray(limit_length_img(pfft2img(img)))
                        png.save(path + ".png")
                    with span("ddim.runner.export.wav"):
                        wav = pfft2wav(img, config.sampling.virtual_samplerate,
                                       dtype=np.int32, HPI=config.sampling.HPI)
                        wav_write(path + ".wav", rate, wav)

    def _sampler_params(self, params, x, cond=None):
        """The tree the sampler passes on every step, made once per run:
        ``prepare_params`` under the eval config, or on sp meshes
        ``sp_sampling_bundle``'s; for the SD UNet its prepared weights and
        the doubled batch's embeddings (``guidance_rows`` of cond, else of
        ``draw_conditioning``)."""
        with span("ddim.runner.prepare"):
            if self.sd:
                text, uncond = (cond if cond is not None
                                else self.draw_conditioning(x.shape[0]))
                return {"unet": sd_unet.prepare_params(params, self.eval_cfg),
                        "cond": guidance_rows(text, uncond,
                                              self.eval_cfg.dtype)}
            if self.mesh is not None and self.mesh.sp > 1:
                return sp_sampling_bundle(params, self.eval_cfg, self.mesh,
                                          x.shape[2])
            return prepare_params(params, self.eval_cfg)

    def _sampler_for_state(self, x):
        """(sampler, x_state, finalize) for a start noise x [B, C, T, F].

        The sampler carries this rank's block of the state (all of it
        without a mesh). On one device and on dp meshes that is the unpadded
        flat fp32 state [B, T, F·C] of the kernel forward
        (``apply_model_flat_io``), with noise drawn channel-shaped then
        reshaped, as the JAX package's flat-io adapters, or [B, C, T, F]
        through ``apply_model`` where ``flat_route`` refuses the model; on
        sp meshes the block [B, C, T/sp, F] of the sequence-parallel forward
        (``apply_model_sp_local``). Every rank draws the whole batch's noise
        and keeps its block. Kept states and the final state are gathered
        back to the global [B, C, T, F] on every rank (``finalize``). The
        SD UNet's state is x itself, under the guided denoiser."""
        cfg, mesh = self.eval_cfg, self.mesh
        kind = getattr(self.args, "sample_type", "generalized")
        scan_chunk = int(getattr(self.config.sampling, "scan_chunk", 100))
        shape = tuple(x.shape)

        if self.sd:
            def unet(params, xl, t, cond):
                return sd_unet.apply_model(params, xl, t, cond, cfg)

            scale = float(self.config.sampling.guidance_scale)
            sampler = ScanSampler(guided_denoiser(unet, scale), kind=kind,
                                  scan_chunk=scan_chunk)
            return sampler, x.contiguous(), lambda xl: xl

        if mesh is not None and mesh.sp > 1:
            check_sp_time(shape[2], cfg, mesh.sp)

            def sp_fn(params, xl, t):
                return apply_model_sp_local(params, xl, t, cfg, mesh)

            def sp_noise(gen, xl):
                n = torch.randn(shape, generator=gen)
                return shard_batch(mesh, n, time_axis=2).to(xl.device)

            def gather(xl):
                return gather_batch(mesh, xl, shape, time_axis=2)

            sampler = ScanSampler(sp_fn, kind=kind, scan_chunk=scan_chunk,
                                  state_to_saved=gather,
                                  noise_builder=sp_noise)
            return (sampler, shard_batch(mesh, x, time_axis=2).contiguous(),
                    gather)

        if not flat_route(cfg):
            def plain(params, xl, t):
                return apply_model(params, xl, t, cfg)

            def plain_noise(gen, xl):
                return shard_batch(mesh, torch.randn(shape, generator=gen)
                                   ).to(xl.device)

            def gather_plain(xl):
                return gather_batch(mesh, xl, shape)

            sampler = ScanSampler(plain, kind=kind, scan_chunk=scan_chunk,
                                  state_to_saved=gather_plain,
                                  noise_builder=plain_noise)
            return (sampler, shard_batch(mesh, x).contiguous(),
                    gather_plain)

        to_flat, from_flat = flat_io_adapters(cfg)

        def flat(params, xf, t):
            return apply_model_flat_io(params, xf, t, cfg)

        def noise_builder(gen, xf):
            n = torch.randn((shape[0], cfg.channels, xf.shape[1], cfg.f_size),
                            generator=gen)
            return to_flat(shard_batch(mesh, n).to(xf.device))

        def saved(xf):
            return gather_batch(mesh, from_flat(xf), shape)

        sampler = ScanSampler(flat, kind=kind, scan_chunk=scan_chunk,
                              state_to_saved=saved,
                              noise_builder=noise_builder)
        return sampler, to_flat(shard_batch(mesh, x)).contiguous(), saved
