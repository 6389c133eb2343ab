"""Optimizers and the warmup schedule (port of
``ddim_audio_tpu/training/optim.py``, which builds them from optax
transforms): Adam / AdamW / AdaBelief / RMSProp / SGD chosen by config name,
the Noam-style warmup ``lr · min(((1+s)/w)^-0.5, (1+s)/w)``, per-group
gradient clipping and per-group optimizers.

Functional code over parameter trees. An optimizer is a chain of links, each
``(init(params) → state dict, update(updates, state, params) → (updates,
state))``; a group's state is the list of its links' state dicts (AdaBelief:
one dict, not a list), which is also how the checkpoint names them
(``checkpoint.py``). Step counts are 0-d int32 tensors on the parameters'
device and every scalar that depends on them is computed there in fp32, so
a step needs no host synchronisation and follows the JAX package's fp32
arithmetic. The schedule is read at the count BEFORE the increment; the
bias corrections use the count after it.
"""

from __future__ import annotations

import torch

from ..utils.tree import tree_leaves, tree_map
from .grouping import group_labels


def noam_schedule(base_lr: float, warmup: int):
    """step → lr · min(((1+step)/w)^-0.5, (1+step)/w); step may be a Python
    number or a 0-d tensor."""

    def schedule(step):
        s = (1.0 + step) / warmup
        if isinstance(s, torch.Tensor):
            return base_lr * torch.minimum(s ** -0.5, s)
        return base_lr * min(s ** -0.5, s)

    return schedule


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _count(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _lr_at(lr, count):
    return lr(count) if callable(lr) else lr


def _tensor_norm(u, norm_ord):
    if norm_ord == 2:
        return torch.sqrt(torch.sum(torch.square(u)))
    return torch.sum(torch.abs(u) ** norm_ord) ** (1.0 / norm_ord)


def adabelief(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, *,
              amsgrad=False, clip_step=None, norm_ord=2):
    """AdaBelief as the JAX package has it: the variance of the gradient
    around its EMA with eps added INSIDE ``s`` every step and again in the
    denominator, decoupled decay ``lr·wd·p``, no rectification, optional
    amsgrad, optional per-tensor step clip (each tensor's update rescaled
    to a ``norm_ord``-norm of at most ``clip_step``). The state carries the
    mean per-tensor update norm (``update_norm``) for the log. The link
    returns the final update (learning rate applied)."""

    def init(params):
        state = {"count": _count(params), "mu": _zeros(params),
                 "s": _zeros(params)}
        if amsgrad:
            state["s_max"] = _zeros(params)
        state["update_norm"] = torch.zeros(
            (), device=tree_leaves(params)[0].device)
        return state

    def update(grads, state, params):
        count = state["count"] + 1
        lr = _lr_at(learning_rate, state["count"])
        bc1 = 1.0 - b1 ** count.float()
        bc2 = 1.0 - b2 ** count.float()
        mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state["mu"], grads)
        s = tree_map(lambda v, g, m: b2 * v + (1.0 - b2) * torch.square(g - m)
                     + eps, state["s"], grads, mu)
        new = {"count": count, "mu": mu, "s": s}
        denom_src = s
        if amsgrad:
            denom_src = new["s_max"] = tree_map(torch.maximum,
                                                state["s_max"], s)

        def step(m, v, p):
            u = -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
            if weight_decay != 0.0:
                u = u - (lr * weight_decay) * p
            if clip_step is not None:
                n = _tensor_norm(u, norm_ord)
                u = u * torch.clamp(clip_step / (n + 1e-30), max=1.0)
            return u

        updates = tree_map(step, mu, denom_src, params)
        norms = [_tensor_norm(u, norm_ord) for u in tree_leaves(updates)]
        new["update_norm"] = torch.mean(torch.stack(norms))
        return updates, new

    return init, update


def _scale_by_adam(b1, b2, eps):
    def init(params):
        return {"count": _count(params), "mu": _zeros(params),
                "nu": _zeros(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        bc1 = 1.0 - b1 ** count.float()
        bc2 = 1.0 - b2 ** count.float()
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state["nu"])
        updates = tree_map(
            lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return init, update


def _scale_by_torch_amsgrad(b1, b2, eps):
    """torch.optim.Adam(amsgrad=True): the running max is over the RAW
    second moment, bias-corrected with the current step."""

    def init(params):
        return {"count": _count(params), "mu": _zeros(params),
                "nu": _zeros(params), "nu_max": _zeros(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        bc1 = 1.0 - b1 ** count.float()
        bc2 = 1.0 - b2 ** count.float()
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                      state["nu"], grads)
        nu_max = tree_map(torch.maximum, state["nu_max"], nu)
        updates = tree_map(
            lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu_max)
        return updates, {"count": count, "mu": mu, "nu": nu, "nu_max": nu_max}

    return init, update


def _add_decayed_weights(wd):
    def update(updates, state, params):
        return tree_map(lambda u, p: u + wd * p, updates, params), state

    return (lambda params: {}), update


def _scale_by_rms(decay, eps):
    def update(grads, state, params):
        nu = tree_map(lambda g, v: (1 - decay) * (g * g) + decay * v, grads,
                      state["nu"])
        updates = tree_map(lambda n, g: (1 / (torch.sqrt(n) + eps)) * g, nu,
                           grads)
        return updates, {"nu": nu}

    return (lambda params: {"nu": _zeros(params)}), update


def _trace(decay):
    def update(grads, state, params):
        trace = tree_map(lambda g, t: g + decay * t, grads, state["trace"])
        return trace, {"trace": trace}

    return (lambda params: {"trace": _zeros(params)}), update


def _scale_by_learning_rate(lr):
    """updates · (−lr). A schedule keeps its own count (read before the
    increment); a constant keeps no state."""
    if not callable(lr):
        return ((lambda params: {}),
                lambda updates, state, params: (
                    tree_map(lambda u: -lr * u, updates), state))

    def update(updates, state, params):
        step = -lr(state["count"])
        return (tree_map(lambda u: step * u, updates),
                {"count": state["count"] + 1})

    return (lambda params: {"count": _count(params)}), update


class GroupOptimizer:
    """A chain of links over one group's parameter subtree. ``chained`` is
    False for the single-link AdaBelief, whose state is the link's dict
    itself; otherwise the state is the list of the links' dicts."""

    def __init__(self, links, chained: bool = True):
        self.links, self.chained = links, chained

    def init(self, params):
        states = [init(params) for init, _ in self.links]
        return states if self.chained else states[0]

    def update(self, grads, state, params):
        states = state if self.chained else [state]
        new = []
        for (_, update), st in zip(self.links, states):
            grads, st = update(grads, st, params)
            new.append(st)
        return grads, (new if self.chained else new[0])


def build_group_optimizer(group_cfg) -> GroupOptimizer:
    """One group's optimizer from its config namespace
    (``optimization.optimizer.<group>``), with the torch optimizers'
    argument semantics as the JAX package keeps them: Adam and RMSProp take
    ``weight_decay`` as L2 into the gradient before the moments, AdamW
    decouples it, Adam / AdamW honour ``amsgrad``; absent keys mean the
    torch defaults (0.0 / False)."""
    name = group_cfg.optimizer
    warmup = getattr(group_cfg, "warmup", None)
    lr = noam_schedule(group_cfg.lr, warmup) if warmup else group_cfg.lr
    wd = float(getattr(group_cfg, "weight_decay", 0.0) or 0.0)
    amsgrad = bool(getattr(group_cfg, "amsgrad", False))
    l2_into_grad = [_add_decayed_weights(wd)] if wd else []

    if name in ("Adam", "AdamW"):
        b1, b2, eps = group_cfg.beta[0], group_cfg.beta[1], group_cfg.eps
        scaler = (_scale_by_torch_amsgrad if amsgrad else _scale_by_adam)(
            b1, b2, eps)
        if name == "Adam":
            chain = l2_into_grad + [scaler]
        else:  # decoupled decay after the adaptive scaling
            chain = [scaler] + l2_into_grad
        return GroupOptimizer(chain + [_scale_by_learning_rate(lr)])
    if name == "AdaBelief":
        return GroupOptimizer([adabelief(
            lr, b1=group_cfg.beta[0], b2=group_cfg.beta[1], eps=group_cfg.eps,
            weight_decay=wd, amsgrad=amsgrad,
            clip_step=getattr(group_cfg, "clip_step", None),
            norm_ord=getattr(group_cfg, "norm_ord", 2))], chained=False)
    if name == "RMSProp":
        return GroupOptimizer(
            l2_into_grad
            + [_scale_by_rms(0.99, float(getattr(group_cfg, "eps", 1e-8))),
               _scale_by_learning_rate(lr)])
    if name == "SGD":
        return GroupOptimizer([_trace(0.9), _scale_by_learning_rate(lr)])
    raise NotImplementedError(f"Optimizer {name} not understood.")


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(x))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """optax's rule: leaves scale by ``max_norm / norm`` only when ``norm >=
    max_norm``, with no epsilon (torch's ``clip_grad_norm_`` has one)."""
    norm = global_norm(tree)
    keep = norm < max_norm
    return tree_map(
        lambda t: torch.where(keep, t, (t / norm) * max_norm), tree)


def _subtree(tree, labels, group):
    return {top: tree[top] for top in sorted(tree) if labels[top] == group}


class Optimizer:
    """Per-group clip, then per-group optimizer, over the whole tree. The
    state is ``{group: GroupOptimizer state}``; a group's moments hold only
    its own top-level subtrees."""

    def __init__(self, optimization_cfg, params):
        self.opt_labels, opt_groups = group_labels(optimization_cfg.optimizer,
                                                   params)
        self.optimizers = {name: build_group_optimizer(ns)
                           for name, ns in opt_groups.items()}
        self.clip_labels, clip_groups = group_labels(
            optimization_cfg.grad_norm, params)
        self.clips = {name: getattr(ns, "grad_clip", None)
                      for name, ns in clip_groups.items()}

    def init(self, params):
        return {name: opt.init(_subtree(params, self.opt_labels, name))
                for name, opt in self.optimizers.items()}

    @torch.no_grad()
    def update(self, grads, state, params):
        """(updates, new state): add the updates to the parameters."""
        clipped = {}
        for name, clip in self.clips.items():
            sub = _subtree(grads, self.clip_labels, name)
            clipped.update(sub if clip is None
                           else clip_by_global_norm(sub, clip))
        updates, new_state = {}, {}
        for name, opt in self.optimizers.items():
            u, new_state[name] = opt.update(
                _subtree(clipped, self.opt_labels, name), state[name],
                _subtree(params, self.opt_labels, name))
            updates.update(u)
        return updates, new_state


def build_optimizer(optimization_cfg, params) -> Optimizer:
    return Optimizer(optimization_cfg, params)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
