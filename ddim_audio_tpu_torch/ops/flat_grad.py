"""Differentiable flat-layout conv ops: the training side of the flat kernels
(port of ``ddim_audio_tpu/ops/flat_grad.py``).

The backward of each flat conv is two more flat ops:

- dx is a forward kernel run on the cotangent with the spatially flipped,
  I/O-swapped HWIO weight: the 3×3 conv's own kernel, and for the strided
  pair the OTHER kernel (dx of the down conv is the transposed up conv and
  the reverse), with a zero bias;
- dW is a kernel of its own, ``conv_dw_flat`` / ``conv_down_dw_flat`` /
  ``conv_up_dw_flat``: the ports of the TPU kernels ``_dw_kernel``,
  ``_down_dw_kernel`` and ``_up_dw_kernel``. On a CUDA tensor each launches
  the hand-written Hopper kernel (``csrc/conv_dw.cu``; what bounds it and why
  the design: the note at the top of that file), on a CPU tensor its plain
  PyTorch twin (``*_plain``). No fallback from one to the other. The kernels
  write HWIO fp32 directly (per-block partial sums finished by
  ``torch.sum``: no atomics, the same bits run to run); in fp32 all three
  run split TF32 on the tensor cores (``tile_plan.conv3x3_dw_plan``,
  ``conv_down_dw_plan``, ``conv_up_dw_plan``).

``conv3x3_flat_t`` / ``conv_down_flat_t`` / ``conv_up_flat_t`` tie forward,
dx and dW together as ``torch.autograd.Function``s. They take the fp32
master weight, cast it to the activation's dtype for the kernels and return
its gradient in fp32. GroupNorm (``gn_flat``) is plain torch arithmetic on
the flat [B, T, F·C] array with the analytic backward of the JAX package;
SiLU is torch's. ``resblock_flat_train`` is the differentiable resblock.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ._cuda import (
    check,
    check_operand,
    kernels,
    ptr,
    require_cuda_dtype,
    stream_ptr,
    twin_result,
    use_twin,
)
from .conv_flat import conv3x3_flat, wide_dtype
from .conv_strided import conv_down_flat, conv_up_flat

GROUPS = 8
EPS = 1e-6


# ----------------------------------------------------------- dW kernels --

def _as4(x, c: int) -> torch.Tensor:
    """Flat [B, T, F·C] → [B, T, F, C] in the twin's accumulation dtype."""
    b, t, fc = x.shape
    return x.reshape(b, t, fc // c, c).to(wide_dtype(x))


def _tap_sum(xs, gs):
    """Σ over (b, t, f) of xsᵀ·gs: [B, T, F, Ci], [B, T, F, Co] → [Ci, Co]."""
    return torch.einsum("btfi,btfo->io", xs, gs)


def conv_dw_flat_plain(x, g, *, c: int):
    """Plain twin of ``conv_dw_flat``: per tap, the zero-padded shifted x
    against g, contracted over every position (fp32)."""
    x4, g4 = _as4(x, c), _as4(g, c)
    _, t, f, _ = x4.shape
    xp = F.pad(x4, (0, 0, 1, 1, 1, 1))
    return torch.stack([
        torch.stack([_tap_sum(xp[:, kh:kh + t, kw:kw + f], g4)
                     for kw in range(3)]) for kh in range(3)])


def conv_down_dw_flat_plain(x, g, *, c_in: int, c_out: int):
    """Plain twin of ``conv_down_dw_flat``: tap (kh, kw) meets x at
    (2t' + kh − 1, 2f' + kw − 1)."""
    x4, g4 = _as4(x, c_in), _as4(g, c_out)
    _, t2, f2, _ = g4.shape
    xp = F.pad(x4, (0, 0, 1, 1, 1, 1))
    return torch.stack([
        torch.stack([_tap_sum(xp[:, kh:kh + 2 * t2:2, kw:kw + 2 * f2:2], g4)
                     for kw in range(4)]) for kh in range(4)])


def conv_up_dw_flat_plain(x, g, *, c_in: int, c_out: int):
    """Plain twin of ``conv_up_dw_flat``, in the stored convention (the
    equivalent forward kernel on the zero-dilated input): tap k meets the
    output rows of parity k & 1, at x shifted by (k + 1) // 2 − 1."""
    x4, g4 = _as4(x, c_in), _as4(g, c_out)
    _, t, f, _ = x4.shape
    xp = F.pad(x4, (0, 0, 1, 1, 1, 1))

    def tap(kh, kw):
        dh, dw = (kh + 1) // 2, (kw + 1) // 2  # shift + 1 (the padding)
        return _tap_sum(xp[:, dh:dh + t, dw:dw + f], g4[:, kh & 1::2, kw & 1::2])

    return torch.stack([torch.stack([tap(kh, kw) for kw in range(4)])
                        for kh in range(4)])


def _launch_dw(wrapper, mode: int, x, g, c_in: int, c_out: int):
    """Check the operands, launch ``ddim_conv_dw`` and finish the partials."""
    name = wrapper.__name__
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    b, t, fc = x.shape
    if fc % c_in or c_in % 8 or c_out % 8:
        raise ValueError(f"{name} kernel: needs F·C_in % C_in == 0 and "
                         f"C_in, C_out % 8 == 0, got F·C_in={fc}, "
                         f"C_in={c_in}, C_out={c_out}")
    f = fc // c_in
    if mode == 1 and (t % 2 or f % 2):
        raise ValueError(f"{name}: T={t} and F={f} must be even")
    g_shape = {0: (b, t, f * c_out), 1: (b, t // 2, (f // 2) * c_out),
               2: (b, 2 * t, 2 * f * c_out)}[mode]
    bf16 = require_cuda_dtype(x, name)
    dev = x.device
    check_operand(x, "x", device=dev)
    check_operand(g, "g", device=dev, dtype=x.dtype, shape=g_shape)
    k = 3 if mode == 0 else 4
    with torch.cuda.device(dev):
        lib = kernels()
        splits = lib.ddim_conv_dw_splits(mode, b, t, f, c_in, c_out, bf16)
        part = torch.empty((splits, k, k, c_in, c_out), dtype=torch.float32,
                           device=dev)
        err = lib.ddim_conv_dw(ptr(x), ptr(g), ptr(part), mode, b, t, f, c_in,
                               c_out, bf16, stream_ptr(x))
    check(err, name)
    wrapper.launches += 1
    # one share: the partial is the sum, with no launch of torch.sum
    return part[0] if splits == 1 else part.sum(dim=0)


def conv_dw_flat(x, g, *, c: int):
    """Weight gradient of ``conv3x3_flat``: x, g [B, T, F·C] (both fp32 or
    both bf16) → dW [3, 3, C, C] HWIO fp32,
    ``dW[kh, kw, ci, co] = Σ x[b, t+kh−1, f+kw−1, ci] · g[b, t, f, co]``
    with x zero outside the array."""
    if use_twin(x):
        return twin_result("conv_dw_flat", conv_dw_flat_plain(x, g, c=c), x,
                           lambda: conv_dw_flat(x, g, c=c))
    return _launch_dw(conv_dw_flat, 0, x, g, c, c)


def conv_down_dw_flat(x, g, *, c_in: int, c_out: int):
    """Weight gradient of ``conv_down_flat``: x [B, T, F·C_in], g
    [B, T/2, (F/2)·C_out] → dW [4, 4, C_in, C_out] HWIO fp32."""
    if use_twin(x):
        kw = dict(c_in=c_in, c_out=c_out)
        return twin_result("conv_down_dw_flat",
                           conv_down_dw_flat_plain(x, g, **kw), x,
                           lambda: conv_down_dw_flat(x, g, **kw))
    return _launch_dw(conv_down_dw_flat, 1, x, g, c_in, c_out)


def conv_up_dw_flat(x, g, *, c_in: int, c_out: int):
    """Weight gradient of ``conv_up_flat``: x [B, T, F·C_in], g
    [B, 2T, 2F·C_out] → dW [4, 4, C_in, C_out] fp32 in the stored
    (equivalent-forward) convention."""
    if use_twin(x):
        kw = dict(c_in=c_in, c_out=c_out)
        return twin_result("conv_up_dw_flat",
                           conv_up_dw_flat_plain(x, g, **kw), x,
                           lambda: conv_up_dw_flat(x, g, **kw))
    return _launch_dw(conv_up_dw_flat, 2, x, g, c_in, c_out)


conv_dw_flat.launches = 0
conv_down_dw_flat.launches = 0
conv_up_dw_flat.launches = 0


# ------------------------------------------------------ trainable convs --

def _flip_swap(w, dtype):
    """HWIO weight of the dx conv: flipped in (kh, kw), I/O swapped, in the
    cotangent's dtype and contiguous (the kernels demand both)."""
    return w.flip(0, 1).transpose(2, 3).to(dtype).contiguous()


def _channel_sum(g, c: int):
    """Σ over (T, F) of the wide cotangent: [B, T, F·C] → [B, C]."""
    return _as4(g, c).sum(dim=(1, 2))


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, add, c):
        ctx.save_for_backward(x, w)
        ctx.c, ctx.add_ndim = c, add.ndim
        return conv3x3_flat(x, w.to(x.dtype).contiguous(), c=c, add=add)

    @staticmethod
    def backward(ctx, gout):
        x, w = ctx.saved_tensors
        c = ctx.c
        gout = gout.contiguous()
        dx = dw = dadd = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_flat(gout, _flip_swap(w, gout.dtype), c=c)
        if ctx.needs_input_grad[1]:
            dw = conv_dw_flat(x, gout, c=c).to(w.dtype)
        if ctx.needs_input_grad[2]:
            dadd = _channel_sum(gout, c)
            if ctx.add_ndim == 1:
                dadd = dadd.sum(dim=0)
        return dx, dw, dadd, None


class _ConvDown(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, c_in, c_out):
        ctx.save_for_backward(x, w)
        ctx.c_in, ctx.c_out = c_in, c_out
        return conv_down_flat(x, w.to(x.dtype).contiguous(), bias, c_in=c_in,
                              c_out=c_out)

    @staticmethod
    def backward(ctx, gout):
        x, w = ctx.saved_tensors
        c_in, c_out = ctx.c_in, ctx.c_out
        gout = gout.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            zero = torch.zeros(c_in, dtype=torch.float32, device=x.device)
            dx = conv_up_flat(gout, _flip_swap(w, gout.dtype), zero,
                              c_in=c_out, c_out=c_in)
        if ctx.needs_input_grad[1]:
            dw = conv_down_dw_flat(x, gout, c_in=c_in, c_out=c_out).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = _channel_sum(gout, c_out).sum(dim=0)
        return dx, dw, db, None, None


class _ConvUp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, c_in, c_out):
        ctx.save_for_backward(x, w)
        ctx.c_in, ctx.c_out = c_in, c_out
        return conv_up_flat(x, w.to(x.dtype).contiguous(), bias, c_in=c_in,
                            c_out=c_out)

    @staticmethod
    def backward(ctx, gout):
        x, w = ctx.saved_tensors
        c_in, c_out = ctx.c_in, ctx.c_out
        gout = gout.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            zero = torch.zeros(c_in, dtype=torch.float32, device=x.device)
            dx = conv_down_flat(gout, _flip_swap(w, gout.dtype), zero,
                                c_in=c_out, c_out=c_in)
        if ctx.needs_input_grad[1]:
            dw = conv_up_dw_flat(x, gout, c_in=c_in, c_out=c_out).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = _channel_sum(gout, c_out).sum(dim=0)
        return dx, dw, db, None, None


def conv3x3_flat_t(x, w, add, *, c: int):
    """Trainable flat 3×3 conv in its bare mode (no prologue): x
    [B, T, F·C]; w [3, 3, C, C] HWIO master weight; add: bias [C] or
    per-sample embedding [B, C]. Gradients: dx through the same kernel, dW
    through ``conv_dw_flat``, dadd = Σ over (T, F) of the cotangent, per
    sample or summed over B by add's rank."""
    return _Conv3x3.apply(x, w, add, c)


def conv_down_flat_t(x, w, bias, *, c_in: int, c_out: int):
    """Trainable flat k4 s2 down conv (w: HWIO [4, 4, C_in, C_out])."""
    return _ConvDown.apply(x, w, bias, c_in, c_out)


def conv_up_flat_t(x, w, bias, *, c_in: int, c_out: int):
    """Trainable flat transposed k4 s2 up conv (w: the stored
    equivalent-forward HWIO [4, 4, C_in, C_out])."""
    return _ConvUp.apply(x, w, bias, c_in, c_out)


# ------------------------------------------------------------ GroupNorm --

def _fold_groups(a, f: int, cpg: int):
    """Per-lane [B, F·C] → per-group [B, G] sums."""
    return a.reshape(a.shape[0], f, GROUPS, cpg).sum(dim=(1, 3))


def _all_reduce_folds(folds, group):
    """[B, G] group folds summed over the ranks of ``group`` (the sp ranks
    that split T) by one all-reduce; unchanged without a group."""
    if group is None:
        return folds
    both = torch.stack(folds)
    dist.all_reduce(both, group=group)
    return tuple(both.unbind(0))


def _gn_forward(x, gamma, beta, f: int, c: int, group=None):
    """(out, mean [B, G], rstd [B, G]) from fp32 (Σx, Σx²) over T (over the
    whole clip's T with an sp ``group``)."""
    _, t, _ = x.shape
    cpg = c // GROUPS
    n = t * f * cpg * _ranks(group)
    xf = x.to(wide_dtype(x))
    s1g, s2g = _all_reduce_folds((_fold_groups(xf.sum(dim=1), f, cpg),
                                  _fold_groups((xf * xf).sum(dim=1), f, cpg)),
                                 group)
    mean = s1g / n
    var = s2g / n - mean.square()
    rstd = torch.rsqrt(var.clamp_min(0.0) + EPS)
    scale_c = rstd.repeat_interleave(cpg, dim=1) * gamma[None, :]
    shift_c = -(mean * rstd).repeat_interleave(cpg, dim=1) * gamma[None, :]
    if beta is not None:
        shift_c = shift_c + beta[None, :]
    out = xf * scale_c.repeat(1, f)[:, None, :] + shift_c.repeat(1, f)[:, None, :]
    return out.to(x.dtype), mean, rstd


def _ranks(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _GroupNormFlat(torch.autograd.Function):
    """dx = rstd·(γ·dy − S₁/N − x̂·S₂/N) per group, with S₁ = Σ γ·dy and
    S₂ = Σ γ·dy·x̂; dγ = Σ dy·x̂, dβ = Σ dy: all from the per-lane partials
    Σ_t dy and Σ_t dy·x (one pass over (dy, x), one affine write). With an
    sp group the forward's (Σx, Σx²) and the backward's S₁ and S₂ group
    folds are all-reduced over it (this Function issues the collectives of
    its backward itself), while dγ and dβ stay this rank's partial sums,
    which the train step adds over sp once."""

    @staticmethod
    def forward(ctx, gamma, beta, x, f, c, group):
        out, mean, rstd = _gn_forward(x, gamma, beta, f, c, group)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.f, ctx.c, ctx.has_beta, ctx.group = f, c, beta is not None, group
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        f, c, group = ctx.f, ctx.c, ctx.group
        b, t, _ = x.shape
        cpg = c // GROUPS
        n = t * f * cpg * _ranks(group)
        xf, dyf = x.to(wide_dtype(x)), dy.to(wide_dtype(x))
        sd = dyf.sum(dim=1)            # [B, F·C]
        sdx = (dyf * xf).sum(dim=1)
        gamma_lane = gamma.repeat(f)[None]

        s1, s2x = _all_reduce_folds((_fold_groups(sd * gamma_lane, f, cpg),
                                     _fold_groups(sdx * gamma_lane, f, cpg)),
                                    group)                    # Σ γ·dy, Σ γ·dy·x
        s2 = rstd * (s2x - mean * s1)
        rstd_c = rstd.repeat_interleave(cpg, dim=1)               # [B, C]
        mean_c = mean.repeat_interleave(cpg, dim=1)
        s1_c = s1.repeat_interleave(cpg, dim=1)
        s2_c = s2.repeat_interleave(cpg, dim=1)
        a_c = rstd_c * gamma[None, :]
        b_c = -rstd_c.square() * s2_c / n
        c_c = (-rstd_c * s1_c + mean_c * rstd_c.square() * s2_c) / n
        dx = (dyf * a_c.repeat(1, f)[:, None, :]
              + xf * b_c.repeat(1, f)[:, None, :]
              + c_c.repeat(1, f)[:, None, :])
        dg_lane = rstd_c.repeat(1, f) * (sdx - mean_c.repeat(1, f) * sd)
        dgamma = dg_lane.reshape(b, f, c).sum(dim=(0, 1))
        dbeta = sd.reshape(b, f, c).sum(dim=(0, 1)) if ctx.has_beta else None
        return dgamma.to(gamma.dtype), dbeta, dx.to(x.dtype), None, None, None


def gn_flat(pnorm, x, *, f: int, c: int, sp_group=None):
    """Differentiable GroupNorm(8, C, eps 1e-6) over flat [B, T, F·C] from
    fp32 statistics, with the analytic backward. ``sp_group``: x is this
    rank's time block of a clip split over the group's ranks; the statistics
    are the whole clip's (``_GroupNormFlat``)."""
    gamma = pnorm["g"].to(wide_dtype(x))
    beta = pnorm.get("b")
    if beta is not None:
        beta = beta.to(wide_dtype(x))
    return _GroupNormFlat.apply(gamma, beta, x, f, c, sp_group)


def resblock_flat_train(p, x_flat, temb, *, f: int, c: int, conv=None,
                        sp_group=None):
    """Differentiable flat residual block: GN → SiLU → conv (+temb) → SiLU →
    GN → conv (+bias) → SiLU → GN3 → x + h. ``conv(h, w, add)``: the
    block's conv (default: ``conv3x3_flat_t``, the flat kernels forward and
    backward); ``sp_group``: the GroupNorms' statistics over a clip split
    over the group's ranks (``gn_flat``)."""
    wide = wide_dtype(x_flat)
    if conv is None:
        def conv(h, w, add):
            return conv3x3_flat_t(h, w, add, c=c)
    h = F.silu(gn_flat(p["norm1"], x_flat, f=f, c=c, sp_group=sp_group))
    h = F.silu(conv(h, p["conv1"]["w"], temb.to(wide)))
    h = gn_flat(p["norm2"], h, f=f, c=c, sp_group=sp_group)
    h = F.silu(conv(h, p["conv2"]["w"], p["conv2"]["b"].to(wide)))
    return x_flat + gn_flat(p["norm3"], h, f=f, c=c, sp_group=sp_group)
