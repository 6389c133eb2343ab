"""One optimizer step of ddim-audio in plain PyTorch float32, written from
the configuration's equations.

Loss: x_t = sqrt(a)·x0 + sqrt(1 − a)·e with a = ᾱ_t (float32), the squared
error of the ε-prediction summed over (C, T, F) and averaged over the
batch; the gradient is taken a few samples at a time and added up, which
is the same sum.

Update, per the ``optimization`` section: the gradients of every leaf are
clipped together to a global norm of ``grad_clip`` (scaled by clip / norm
only when the norm is at least clip); leaves under a group's top-level
names take that group's optimizer, the rest the ``default`` group's; the
learning rate of step s (counted from 0) is lr · min(u^-0.5, u) with
u = (1 + s) / warmup.

- AdaBelief: m = b1·m + (1 − b1)·g; s = b2·s + (1 − b2)·(g − m)² + eps;
  p += −lr·((m / (1 − b1^n)) / (sqrt(s / (1 − b2^n)) + eps)) − lr·wd·p.
- AdamW: m = b1·m + (1 − b1)·g; v = b2·v + (1 − b2)·g²;
  p += −lr·((m / (1 − b1^n)) / (sqrt(v / (1 − b2^n)) + eps) + wd·p).

n is the step's count from 1. The EMA follows: e = (1 − μ)·p + μ·e.
"""

from __future__ import annotations

import torch


def leaves(tree, prefix=""):
    """{path: tensor} in a fixed order (dict keys sorted)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def rebuild(tree, flat, prefix=""):
    """The tree's structure with the leaves of ``flat`` ({path: tensor})."""
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], flat, f"{prefix}/{k}") for k in tree}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, flat, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return flat[prefix]


def loss_and_grads(model, params, x0, t, e, abar, masks, chunk: int):
    """(mean loss, {path: gradient}) over the batch, ``chunk`` samples a
    pass. masks: the full batch's dropout keep masks, or None."""
    flat = {k: v.detach().clone().requires_grad_(True)
            for k, v in leaves(params).items()}
    tree = rebuild(params, flat)
    a = torch.as_tensor(abar, device=x0.device)[t][:, None, None, None]
    n = x0.shape[0]
    total = torch.zeros((), dtype=torch.float64, device=x0.device)
    grads = {k: torch.zeros_like(v) for k, v in flat.items()}
    for lo in range(0, n, chunk):
        sl = slice(lo, min(n, lo + chunk))
        x = x0[sl] * torch.sqrt(a[sl]) + e[sl] * torch.sqrt(1.0 - a[sl])
        m = None if masks is None else [mk[sl] for mk in masks]
        out = model(tree, x, t[sl], masks=m)
        loss = (e[sl] - out).square().sum(dim=(1, 2, 3)).sum() / n
        g = torch.autograd.grad(loss, list(flat.values()))
        for k, gk in zip(flat, g):
            grads[k] += gk
        total += loss.detach().double()
    return float(total), grads


def group_of(path: str, optimizer_cfg: dict) -> str:
    top = path.split("/")[1]
    for name, sub in optimizer_cfg.items():
        if top in (sub.get("top_level_name") or []):
            return name
    return "default"


class Optimizer:
    """The configuration's optimizer over a flat {path: tensor} state."""

    def __init__(self, optimization: dict, params_flat: dict):
        self.cfg = optimization["optimizer"]
        clips = {g["grad_clip"] for g in optimization["grad_norm"].values()}
        if any(g.get("top_level_name") for g in
               optimization["grad_norm"].values()) or len(clips) != 1:
            raise ValueError("the reference clips all leaves in one group")
        self.clip = clips.pop()
        self.group = {k: group_of(k, self.cfg) for k in params_flat}
        for name, g in self.cfg.items():
            if g["optimizer"] not in ("AdaBelief", "AdamW") or g.get(
                    "amsgrad") or g.get("clip_step") is not None:
                raise ValueError(f"the reference has no {g['optimizer']} "
                                 "with these options")
        self.m = {k: torch.zeros_like(v) for k, v in params_flat.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params_flat.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params_flat: dict, grads: dict) -> dict:
        """The new parameters; the clipped gradient is kept as ``last_grad``."""
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                              for g in grads.values())).float()
        if norm >= self.clip:
            grads = {k: g / norm * self.clip for k, g in grads.items()}
        self.last_grad = grads
        s, self.count = self.count, self.count + 1
        n = self.count
        out = {}
        for k, p in params_flat.items():
            g = self.cfg[self.group[k]]
            b1, b2 = g["beta"]
            eps, wd = g["eps"], g.get("weight_decay", 0.0)
            u = (1.0 + s) / g["warmup"]
            lr = g["lr"] * min(u ** -0.5, u)
            gr = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * gr
            if g["optimizer"] == "AdaBelief":
                self.v[k] = b2 * self.v[k] + (1 - b2) * (gr - self.m[k]) ** 2 + eps
            else:
                self.v[k] = b2 * self.v[k] + (1 - b2) * gr * gr
            step = (self.m[k] / (1 - b1 ** n)) / (
                torch.sqrt(self.v[k] / (1 - b2 ** n)) + eps)
            if g["optimizer"] == "AdaBelief":
                out[k] = p + (-lr * step - (lr * wd) * p)
            else:
                out[k] = p + (-lr) * (step + wd * p)
        return out
