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

import dataclasses
from typing import Any, Optional

import torch

from ..ops.train_update import Rule
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


def _bias_corrections(state, b1, b2):
    """(count + 1, 1 − b1^(count + 1), 1 − b2^(count + 1)) of a link's state."""
    count = state["count"] + 1
    cf = count.float()
    return count, 1.0 - b1 ** cf, 1.0 - b2 ** cf


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
        count, bc1, bc2 = _bias_corrections(state, b1, b2)
        lr = _lr_at(learning_rate, state["count"])
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
        count, bc1, bc2 = _bias_corrections(state, b1, b2)
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
        count, bc1, bc2 = _bias_corrections(state, b1, b2)
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


def _lr_step(lr, state):
    """(−lr of this step, the learning-rate link's next state): a schedule
    keeps its own count (read before the increment); a constant keeps no
    state."""
    if not callable(lr):
        return -lr, state
    return -lr(state["count"]), {"count": state["count"] + 1}


def _scale_by_learning_rate(lr):
    """updates · (−lr)."""

    def update(updates, state, params):
        step, state = _lr_step(lr, state)
        return tree_map(lambda u: step * u, updates), state

    return (lambda params: {"count": _count(params)} if callable(lr)
            else {}), update


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """A group's chain as one elementwise ``kernel`` rule, which the step
    runs over the whole tree in one pass (``train_step.update_fused``): its
    learning rate, and for Adam ``links``, the places of the scale-by-Adam
    and learning-rate links in the group's state list. The step's scalars
    and the next state come from the same expressions as the per-leaf
    links'."""

    kernel: Rule
    lr: Any
    links: tuple = ()

    def moments(self, state):
        """(first moments, second moments) of the group's state: trees."""
        if self.kernel.kind == "adabelief":
            return state["mu"], state["s"]
        adam = state[self.links[0]]
        return adam["mu"], adam["nu"]

    def step(self, state):
        """((−lr, lr·wd, bc1, bc2), counts) of this step: each scalar a 0-d
        fp32 tensor on the state's device or a Python float; ``counts`` go
        to ``next_state``."""
        k = self.kernel
        if k.kind == "adabelief":
            count, bc1, bc2 = _bias_corrections(state, k.b1, k.b2)
            lr = _lr_at(self.lr, state["count"])
            lr_wd = lr * k.weight_decay if k.weight_decay else 0.0
            return (-lr, lr_wd, bc1, bc2), count
        adam_at, lr_at = self.links
        count, bc1, bc2 = _bias_corrections(state[adam_at], k.b1, k.b2)
        neg_lr, lr_state = _lr_step(self.lr, state[lr_at])
        return (neg_lr, 0.0, bc1, bc2), (count, lr_state)

    def next_state(self, state, counts, mu, second, update_norm):
        """The group's state after the step, structured as the links'."""
        if self.kernel.kind == "adabelief":
            return {"count": counts, "mu": mu, "s": second,
                    "update_norm": update_norm}
        adam_at, lr_at = self.links
        count, lr_state = counts
        new = list(state)
        new[adam_at] = {"count": count, "mu": mu, "nu": second}
        new[lr_at] = lr_state
        return new


class GroupOptimizer:
    """A chain of links over one group's parameter subtree. ``chained`` is
    False for the single-link AdaBelief, whose state is the link's dict
    itself; otherwise the state is the list of the links' dicts. ``rule``:
    the chain as one ``UpdateRule``, or None where the one-pass update does
    not implement it (amsgrad, AdaBelief's clip_step, RMSProp, SGD)."""

    def __init__(self, links, chained: bool = True,
                 rule: Optional[UpdateRule] = None):
        self.links, self.chained, self.rule = links, chained, rule

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
        chain.append(_scale_by_learning_rate(lr))
        rule = None if amsgrad else UpdateRule(
            Rule("adam", ("l2" if name == "Adam" else "decoupled") if wd
                 else "", b1, b2, eps, wd),
            lr, links=(chain.index(scaler), len(chain) - 1))
        return GroupOptimizer(chain, rule=rule)
    if name == "AdaBelief":
        b1, b2, eps = group_cfg.beta[0], group_cfg.beta[1], group_cfg.eps
        clip_step = getattr(group_cfg, "clip_step", None)
        norm_ord = getattr(group_cfg, "norm_ord", 2)
        rule = None if amsgrad or clip_step is not None else UpdateRule(
            Rule("adabelief", "decoupled" if wd else "", b1, b2, eps, wd), lr)
        return GroupOptimizer([adabelief(
            lr, b1=b1, b2=b2, eps=eps, weight_decay=wd, amsgrad=amsgrad,
            clip_step=clip_step, norm_ord=norm_ord)], chained=False,
            rule=rule)
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

    def update_rules(self):
        """Each group's ``UpdateRule`` in ``optimizers``' order, or None
        where a group's chain has none."""
        rules = [opt.rule for opt in self.optimizers.values()]
        return None if any(r is None for r in rules) else rules

    def leaf_tags(self, params) -> tuple:
        """Each leaf's (group, clip group) in flattening order: its places
        in ``optimizers`` and ``clips``."""
        groups, clips = list(self.optimizers), list(self.clips)
        tags = []
        for top in sorted(params):
            tag = (groups.index(self.opt_labels[top]),
                   clips.index(self.clip_labels[top]))
            tags += [tag] * len(tree_leaves(params[top]))
        return tuple(tags)

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
