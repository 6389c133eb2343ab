"""The training step (port of ``ddim_audio_tpu/training/train_step.py``):
antithetic timestep sampling, the simple ε-loss, exact gradient accumulation
over ``training.grad_accum`` microbatches, per-group gradient clipping,
per-group optimizers with Noam warmup, EMA: one function over a
``TrainState``, with no host synchronisation inside it. Metrics come back
as device tensors that the host reads at its own cadence. On a dp mesh each
rank runs its share of the microbatches and one all-reduce averages the
ranks' losses and gradients before the update, which every rank applies; on
a mesh with sp > 1 each rank also keeps only its time block and runs the
sequence-parallel training forward (``parallel/sp.py``), and the same one
all-reduce adds the sp ranks' partial gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..models.unet import apply_model
from ..ops import train_update as fused
from ..parallel.mesh import batch_sharded, shard_batch
from ..parallel.sp import (check_sp_time, flat_train_flags, psum_keep_sp,
                           sp_local_train_forward)
from ..utils.tracing import span
from ..utils.tree import tree_leaves, tree_unflatten
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


# spreads (step seed, microbatch) over generator seeds
_MICRO_STRIDE = 1_000_003


def micro_generator(generator, index: int):
    """The generator of microbatch ``index`` (its global index in the step)
    of the step whose generator is ``generator``: seeded from that
    generator's seed and the index alone, so a microbatch draws the same
    noise and dropout masks whichever rank runs it and whatever ran before
    it. None stays None."""
    if generator is None:
        return None
    seed = (generator.initial_seed() * _MICRO_STRIDE + index + 1) % (1 << 63)
    return torch.Generator(generator.device).manual_seed(seed)


def _all_reduce_sum(group, loss, grads):
    """loss and grads summed over the group's ranks (the default group's for
    None) by one all-reduce of one flat buffer."""
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    parts = torch.split(flat[1:], [g.numel() for g in grads])
    return flat[0], [p.view_as(g) for p, g in zip(parts, grads)]


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


def make_train_step(cfg, config, alphas_cumprod, tx, mesh=None):
    """cfg: ModelConfig; config: the loaded YAML namespace; returns
    ``train_step(state, x0 [B, C, T, F], generator, *, noise_override=None)
    → (state, metrics)``.

    ``training.grad_accum`` (default 1) splits the batch into A microbatches
    run one after the other, averaging losses and gradients: the same
    gradient as the full batch (the loss is a mean of per-sample sums) at
    1/A of the activation memory. A batch that A does not divide raises.

    The generator (on the device of x0) draws the timesteps of the batch;
    microbatch k's noise and FNet dropout masks come from
    ``micro_generator(generator, k)``. ``noise_override=(t, e)`` injects the
    timesteps [B] and the noise [B, C, T, F] instead (the sampler's
    ``noise_override`` likewise): torch cannot reproduce the JAX package's
    random streams, so parity checks hand both the same numbers.

    ``mesh`` (dp only): x0, t and e are the global batch, the same on every
    rank; rank d runs its slice of it as microbatches d·A … d·A + A − 1, and
    the ranks' loss and gradient sums are added by one all-reduce before
    they are averaged, clipped and applied, so a dp × A step is a
    single-device grad_accum dp·A step (a batch that dp does not divide runs
    whole on every rank).

    ``mesh`` with sp > 1, where dp divides the batch and sp the time axis
    (as the JAX step takes its sp branch): each rank also keeps its time
    block of x0 and of the noise (drawn whole from the microbatch's
    generator, so the same numbers as one device's, or injected), runs
    ``parallel.sp.sp_local_train_forward``, completes each sample's
    (C, T, F) sum of the loss over sp (``psum_keep_sp``), and one
    all-reduce over all the ranks adds the sp ranks' partial gradients and
    the dp ranks' sums (the loss from the first rank of each sp row alone)
    before they are divided by dp·A: the same step as one device's
    grad_accum dp·A, in another order of summation."""
    loss_fn = loss_registry[config.model.type]
    num_timesteps = cfg.num_timesteps
    use_ema = bool(config.model.ema)
    mu = float(getattr(config.model, "ema_rate", 0.9999))
    grad_accum = int(getattr(config.training, "grad_accum", 1) or 1)
    alphas_on = {}  # device → the schedule as a tensor, made once

    def train_step(state: TrainState, x0, generator, *, noise_override=None):
        with span("ddim.train.step"):
            return _train_step(state, x0, generator, noise_override)

    def _train_step(state, x0, generator, noise_override):
        if x0.device not in alphas_on:
            alphas_on[x0.device] = torch.as_tensor(
                alphas_cumprod, dtype=torch.float32, device=x0.device)
        alphas = alphas_on[x0.device]
        if noise_override is not None:
            t, e_all = noise_override
        else:
            t = antithetic_timesteps(generator, x0.shape[0], num_timesteps)
            e_all = None
        shape = tuple(x0.shape)
        sp_split = (mesh is not None and mesh.sp > 1
                    and shape[0] % mesh.dp == 0 and shape[2] % mesh.sp == 0)
        split = sp_split or batch_sharded(mesh, shape[0])
        time_axis = 2 if sp_split else None
        first = 0  # the global index of this rank's first microbatch
        if sp_split:
            check_sp_time(shape[2], cfg, mesh.sp)
            flags = flat_train_flags(cfg, shape[2], mesh.sp)
        if split:
            x0 = shard_batch(mesh, x0, time_axis=time_axis)
            t = shard_batch(mesh, t)
            if e_all is not None:
                e_all = shard_batch(mesh, e_all, time_axis=time_axis)
            first = mesh.dp_index * grad_accum
        n = x0.shape[0]
        if n % grad_accum:
            raise ValueError(
                f"batch {n} not divisible by grad_accum {grad_accum}")
        mb = n // grad_accum

        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)

        try:
            loss_sum, grad_sum = None, None
            for g in range(grad_accum):
                sl = slice(g * mb, (g + 1) * mb)
                x0_mb = x0[sl]
                gen = micro_generator(generator, first + g)
                if e_all is not None:
                    e_mb = e_all[sl]
                elif sp_split:  # the whole clip's noise, my time block
                    e_mb = torch.randn(
                        (mb,) + shape[1:], generator=gen, device=x0.device,
                        dtype=x0.dtype).narrow(2, mesh.sp_index * x0.shape[2],
                                               x0.shape[2])
                else:
                    e_mb = torch.randn(x0_mb.shape, generator=gen,
                                       device=x0.device, dtype=x0.dtype)

                if sp_split:
                    def apply_fn(pp, x, tt, gen=gen):
                        return sp_local_train_forward(pp, x, tt, gen, cfg,
                                                      flags, mesh)

                    with span("ddim.train.forward"):
                        loss = psum_keep_sp(loss_fn(
                            apply_fn, state.params, x0_mb, t[sl], e_mb,
                            alphas, keepdim=True), mesh).mean(dim=0)
                else:
                    def apply_fn(pp, x, tt, gen=gen):
                        return apply_model(pp, x, tt, cfg, train=True,
                                           generator=gen)

                    with span("ddim.train.forward"):
                        loss = loss_fn(apply_fn, state.params, x0_mb, t[sl],
                                       e_mb, alphas)
                with span("ddim.train.backward"):
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

        with torch.no_grad(), span("ddim.train.update"):
            count = grad_accum
            if sp_split:
                # every sp rank holds the global loss: the first of each sp
                # row adds it, the others zeros
                lead = loss_sum if mesh.sp_index == 0 else torch.zeros_like(
                    loss_sum)
                loss_sum, grad_sum = _all_reduce_sum(None, lead, grad_sum)
                count *= mesh.dp
            elif split:
                loss_sum, grad_sum = _all_reduce_sum(mesh.dp_group, loss_sum,
                                                     grad_sum)
                count *= mesh.dp
            if count > 1:
                loss_sum = loss_sum / count
            ema = state.ema if use_ema else None
            if fused_route(tx, grad_sum, state.params, ema):
                with span("ddim.train.update.fused"):
                    params, opt_state, ema, grad_norm = update_fused(
                        tx, grad_sum, state.params, state.opt_state, ema, mu,
                        count)
            else:
                params, opt_state, ema, grad_norm = update_plain(
                    tx, grad_sum, state.params, state.opt_state, ema, mu,
                    count)
            metrics = {"loss": loss_sum, "grad_norm": grad_norm}
            _collect_adabelief_stats(opt_state, metrics)
        return TrainState(params=params, opt_state=opt_state, ema=ema,
                          step=state.step + 1), metrics

    return train_step


def fused_route(tx, grads, params, ema) -> bool:
    """Whether the step's update takes ``update_fused``: every group's
    chain has an ``UpdateRule``, and the leaves fit the kernel
    (``ops.train_update.fits``: CUDA fp32 outside ``twin_route``)."""
    return tx.update_rules() is not None and fused.fits(
        grads, tree_leaves(params), None if ema is None else tree_leaves(ema),
        len(tx.optimizers), len(tx.clips))


def update_fused(tx, grads, params, opt_state, ema, ema_rate: float,
                 count: int):
    """The update in one pass (``ops.train_update``), where ``fused_route``
    holds: the arguments and results as ``update_plain``'s. The trees go to
    the kernel as lists of leaves in flattening order with each leaf's
    (group, clip group) and each group's rule and step scalars, and come
    back as trees of the given structure."""
    rules, names = tx.update_rules(), list(tx.optimizers)
    tags = tx.leaf_tags(params)
    members = [[i for i, (k, _) in enumerate(tags) if k == g]
               for g in range(len(names))]
    steps = [rule.step(opt_state[name]) for rule, name in zip(rules, names)]
    moments = [rule.moments(opt_state[name])
               for rule, name in zip(rules, names)]
    firsts, seconds = [None] * len(tags), [None] * len(tags)
    for mine, (first, second) in zip(members, moments):
        for i, a, b in zip(mine, tree_leaves(first), tree_leaves(second)):
            firsts[i], seconds[i] = a, b
    p, m, v, e, grad_norm, update_norms = fused.train_update(
        grads, tree_leaves(params), firsts, seconds,
        None if ema is None else tree_leaves(ema), tags=tags,
        rules=[rule.kernel for rule in rules],
        scalars=[values for values, _ in steps], clips=list(tx.clips.values()),
        ema_rate=ema_rate, count=count)
    new_state = {}
    for k, (rule, name) in enumerate(zip(rules, names)):
        first, second = moments[k]
        new_state[name] = rule.next_state(
            opt_state[name], steps[k][1],
            tree_unflatten(first, [m[i] for i in members[k]]),
            tree_unflatten(second, [v[i] for i in members[k]]),
            update_norms[k])
    return (tree_unflatten(params, p), new_state,
            None if ema is None else tree_unflatten(ema, e), grad_norm)


def update_plain(tx, grads, params, opt_state, ema, ema_rate: float,
                 count: int):
    """The update leaf by leaf (the twin of ``update_fused``): the gradient
    sums ``grads`` (in flattening order) over ``count``, ``tx``'s clip and
    group optimizers, ``apply_updates``, the average (``ema`` None: none).
    Returns (params, opt_state, ema, the gradients' norm before the
    clip)."""
    if count > 1:
        grads = [g / count for g in grads]
    grads = tree_unflatten(params, grads)
    updates, opt_state = tx.update(grads, opt_state, params)
    new_params = apply_updates(params, updates)
    if ema is not None:
        ema = ema_update(ema, new_params, ema_rate)
    return new_params, opt_state, ema, global_norm(grads)
