"""Host spans of the program in a torch profiler's trace.

``span(name)`` marks a block as a ``torch.profiler.record_function`` range
while a torch profiler records, and costs one flag check otherwise: tracing
is on exactly while a profiler runs (``tools/profile_*``,
``port_bench/run.py --trace 1``, any ``torch.profiler`` session), with no
switch of its own. The ranges are ``user_annotation`` events of the
profiler's Chrome trace, on the clock of its kernel, copy and fill events;
nesting gives each its parent.

Every span is named ``ddim.<layer>.<part>``:

- runner (``runners/diffusion_runner.py``): ``ddim.runner.chain`` (a whole
  ``sample_last_only``), ``.prepare`` (the sampler's weights), ``.finalize``,
  ``.filter`` (``denoise_2d``), ``.to_host`` (the wait for the card and the
  copy of the chain's result), ``.export`` > ``.export.clip`` >
  ``.export.png``, ``.export.wav``;
- sampler (``sampling/driver.py``): ``ddim.sampler.loop`` (the step loop),
  ``.step`` (one denoiser step), ``.drain`` (the kept states to the host);
  ``ddim.sampler.guidance`` (``sampling/guidance.py``: the doubled batch,
  its one denoiser call and the combination of its halves, inside
  ``.step``);
- SD UNet (``models/sd_unet.py``): ``ddim.sd.resnet`` (a ResNet block),
  ``ddim.sd.transformer`` (a Transformer2D) > ``ddim.sd.attn.self``,
  ``ddim.sd.attn.cross``, ``ddim.sd.ff`` (each with its LayerNorm and
  residual add), ``ddim.sd.sample`` (``conv_in``, a down or up sampler, the
  output norm and ``conv_out``);
- train step (``training/train_step.py``): ``ddim.train.step`` > per
  microbatch ``.forward`` and ``.backward``, then ``.update`` >
  ``.update.fused`` (the one-pass update, ``ops/train_update.py``, where it
  runs).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()  # reentrant: one object serves every block


def span(name: str):
    """A ``record_function(name)`` context while a torch profiler records,
    else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
