"""The training step (port of ``ddim_audio_tpu/training/train_step.py``):
antithetic timestep sampling, the simple ε-loss, exact gradient accumulation
over ``training.grad_accum`` microbatches, per-group gradient clipping,
per-group optimizers with Noam warmup, EMA: one function over a
``TrainState``, with no host synchronisation inside it. Metrics come back
as device tensors that the host reads at its own cadence.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..models.unet import apply_model
from ..utils.tree import tree_leaves, tree_map
from .ema import ema_init, ema_update
from .losses import loss_registry
from .optim import apply_updates, build_optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    ema: Optional[Any]
    step: torch.Tensor  # 0-d int32 on the parameters' device


def antithetic_timesteps(generator, n: int, num_timesteps: int):
    """t ∪ (T − t − 1), truncated to n; drawn on the generator's device."""
    half = torch.randint(0, num_timesteps, ((n + 1) // 2,),
                         generator=generator, device=generator.device)
    return torch.cat([half, num_timesteps - half - 1])[:n]


def init_train_state(params, optimization_cfg, *, use_ema: bool):
    """(state, tx): tx is the optimizer the step applies."""
    tx = build_optimizer(optimization_cfg, params)
    device = tree_leaves(params)[0].device
    state = TrainState(
        params=params, opt_state=tx.init(params),
        ema=ema_init(params) if use_ema else None,
        step=torch.zeros((), dtype=torch.int32, device=device))
    return state, tx


def _collect_adabelief_stats(opt_state, out: dict) -> dict:
    for name, inner in opt_state.items():
        if isinstance(inner, dict) and "update_norm" in inner:
            out[f"update_norm_{name}"] = inner["update_norm"]
    return out


def make_train_step(cfg, config, alphas_cumprod, tx):
    """cfg: ModelConfig; config: the loaded YAML namespace; returns
    ``train_step(state, x0 [B, C, T, F], generator, *, noise_override=None)
    → (state, metrics)``.

    ``training.grad_accum`` (default 1) splits the batch into A microbatches
    run one after the other, averaging losses and gradients: the same
    gradient as the full batch (the loss is a mean of per-sample sums) at
    1/A of the activation memory. A batch that A does not divide raises.

    The generator (on the device of x0) draws the timesteps, each
    microbatch's noise and the FNet dropout masks. ``noise_override=(t, e)``
    injects the timesteps [B] and the noise [B, C, T, F] instead (the
    sampler's ``noise_override`` likewise): torch cannot reproduce the JAX
    package's random streams, so parity checks hand both the same
    numbers."""
    loss_fn = loss_registry[config.model.type]
    num_timesteps = cfg.num_timesteps
    use_ema = bool(config.model.ema)
    mu = float(getattr(config.model, "ema_rate", 0.9999))
    grad_accum = int(getattr(config.training, "grad_accum", 1) or 1)
    alphas_on = {}  # device → the schedule as a tensor, made once

    def train_step(state: TrainState, x0, generator, *, noise_override=None):
        n = x0.shape[0]
        if n % grad_accum:
            raise ValueError(
                f"batch {n} not divisible by grad_accum {grad_accum}")
        mb = n // grad_accum
        if x0.device not in alphas_on:
            alphas_on[x0.device] = torch.as_tensor(
                alphas_cumprod, dtype=torch.float32, device=x0.device)
        alphas = alphas_on[x0.device]
        if noise_override is not None:
            t, e_all = noise_override
        else:
            t, e_all = antithetic_timesteps(generator, n, num_timesteps), None

        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)

        def apply_fn(pp, x, tt):
            return apply_model(pp, x, tt, cfg, train=True, generator=generator)

        try:
            loss_sum, grad_sum = None, None
            for g in range(grad_accum):
                sl = slice(g * mb, (g + 1) * mb)
                x0_mb = x0[sl]
                if e_all is not None:
                    e_mb = e_all[sl]
                else:
                    e_mb = torch.randn(x0_mb.shape, generator=generator,
                                       device=x0.device, dtype=x0.dtype)
                loss = loss_fn(apply_fn, state.params, x0_mb, t[sl], e_mb,
                               alphas)
                grads = torch.autograd.grad(loss, leaves)
                loss = loss.detach()
                if grad_sum is None:
                    loss_sum, grad_sum = loss, list(grads)
                else:
                    loss_sum = loss_sum + loss
                    torch._foreach_add_(grad_sum, grads)
        finally:
            for p in leaves:
                p.requires_grad_(False)

        with torch.no_grad():
            if grad_accum > 1:
                loss_sum = loss_sum / grad_accum
                grad_sum = [g / grad_accum for g in grad_sum]
            it = iter(grad_sum)
            grads = tree_map(lambda _: next(it), state.params)
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            params = apply_updates(state.params, updates)
            ema = ema_update(state.ema, params, mu) if use_ema else None
            metrics = {"loss": loss_sum, "grad_norm": global_norm(grads)}
            _collect_adabelief_stats(opt_state, metrics)
        return TrainState(params=params, opt_state=opt_state, ema=ema,
                          step=state.step + 1), metrics

    return train_step
