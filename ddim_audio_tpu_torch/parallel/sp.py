"""Sequence parallelism: the denoiser forward with the time axis split over
the sp ranks of a mesh (port of the sampling half of
``ddim_audio_tpu/parallel/sp.py``).

Each rank holds one time block [B, T/sp, …] of every activation:

- 3×3 stride-1 convs: halo exchange of 1 row a side (zeros at the global
  boundary: exactly the conv's zero padding), VALID over T;
- the k4 s2 p1 down conv: halo (1, 2), VALID over T;
- the transposed k4 s2 p1 up conv: halo (1, 1), transpose-conv the haloed
  block, crop 2 output rows a side;
- GroupNorm: the per-channel sums all-reduced over sp, n = T_global·F·C/G;
- the FNet bottleneck: the (T/32-long) token axis all-gathered, the Fourier
  mixing run whole on every rank, this rank's slice kept.

The resblocks, where the work is, run the port's ``conv3x3_flat`` kernels
(float taps, or int8 taps where ``tap_int8_stage`` selects them, as the
single-device forward does) on each rank's block with one halo row a side,
and crop. The kernels' fused statistics would count the halo rows, so the
GroupNorm sums are taken over the cropped outputs (``channel_sums``) and
all-reduced. At the global boundary the halo row holds the per-channel
value that the kernel's prologue maps to exactly 0 (pre_scale·v + pre_shift
= 0), so a missing neighbour contributes what the reference's zero padding
of the post-GroupNorm activation would. The head, the tail and the strided
transitions run as plain convs per block (``F.conv2d`` /
``F.conv_transpose2d``; the JAX package runs them through XLA there too).
``act_store`` (int8 activation storage) does not compose with the halo
exchange and is ignored on sp meshes, as in the JAX package.

The halo rows travel by one all-gather of every rank's edge rows over the sp
group, which both NCCL and gloo run on device tensors (gloo's send/recv take
CPU tensors only), so the same code runs across cards and with several
ranks on one card.

The training half (``sp_local_train_forward``) is differentiable end to end
over the split time axis. Every collective on a gradient path is an
autograd Function that issues its backward collectives itself: the halo
(``_HaloT``: forward the edge-row all-gather, backward an all-gather of the
halo rows' gradients, which each rank adds to the edge rows it sent),
``psum_keep_sp`` (all-reduce; the backward passes the cotangent on) and the
bottleneck's token gather (``_GatherTimeT``: all-gather; the backward
all-reduces the whole cotangent and keeps this rank's slice), and the
GroupNorms' sums (``ops.flat_grad.gn_flat(sp_group=…)``). An all-reduce
whose backward all-reduced again would count every gradient sp times.
Parameter gradients come back as this rank's partial sums; the train step
adds them over sp once. The 3×3 resblock convs run ``conv3x3_flat_t`` (the
kernels' forward, dx and dW) on the block with one halo row a side and crop;
head, tail, transitions and other kernel sizes run as plain convs on
haloed blocks, as the JAX package runs XLA there.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.layers import conv_apply, conv_transpose_apply
from ..models.unet import (
    ModelConfig,
    _bottleneck,
    _remat,
    _temb_chunks,
    prepare_params,
    tap_int8_stage,
)
from ..ops.conv_flat import conv3x3_flat
from ..ops.flat_grad import conv3x3_flat_t, resblock_flat_train
from ..ops.flat_resblock import (
    GROUPS,
    channel_sums,
    conv3x3_taps,
    gn_affine_from_sums,
    resblock_tail,
)
from .mesh import all_gather_cat, gather_batch, shard_batch


def _neighbour_rows(x, left: int, right: int, mesh):
    """(the last ``left`` rows of rank s − 1's block, the first ``right`` rows
    of rank s + 1's) along dim 1, None at the global boundary: one
    all-gather of every rank's edge rows over the sp group."""
    n = mesh.sp
    if n == 1:
        return None, None
    s = mesh.sp_index
    t = x.shape[1]
    edges = torch.cat([x[:, t - left:], x[:, :right]], dim=1).contiguous()
    parts = [torch.empty_like(edges) for _ in range(n)]
    dist.all_gather(parts, edges, group=mesh.sp_group)
    return (parts[s - 1][:, :left] if s > 0 else None,
            parts[s + 1][:, left:] if s < n - 1 else None)


def _halo(x, left: int, right: int, mesh, pad=None):
    """x [B, T_loc, …] → [B, left + T_loc + right, …]: the neighbours' rows,
    and at the global boundary ``pad`` (one row [B, …], broadcast over the
    halo and cast to x's dtype; zeros when None, and then differentiable:
    ``_HaloT``)."""
    if pad is None:
        return _HaloT.apply(x, left, right, mesh)
    return _halo_rows_of(x, left, right, mesh, pad)


def _halo_rows_of(x, left: int, right: int, mesh, pad=None):
    from_left, from_right = _neighbour_rows(x, left, right, mesh)

    def boundary(k):
        shape = (x.shape[0], k) + tuple(x.shape[2:])
        if pad is None:
            return x.new_zeros(shape)
        return pad.unsqueeze(1).expand(shape).to(x.dtype)

    parts = [x]
    if left:
        parts.insert(0, boundary(left) if from_left is None else from_left)
    if right:
        parts.append(boundary(right) if from_right is None else from_right)
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


class _HaloT(torch.autograd.Function):
    """The zero-padded halo, differentiable. The gradient of a halo row
    belongs to the neighbour whose edge row it copied: the backward
    all-gathers every rank's [gradient of its left halo rows, of its right
    halo rows], and rank s adds rank s + 1's left-halo gradient to its last
    rows and rank s − 1's right-halo gradient to its first rows. The
    boundary halos are zeros and carry none."""

    @staticmethod
    def forward(ctx, x, left, right, mesh):
        ctx.left, ctx.right, ctx.mesh, ctx.t = left, right, mesh, x.shape[1]
        return _halo_rows_of(x, left, right, mesh)

    @staticmethod
    def backward(ctx, g):
        left, right, mesh, t = ctx.left, ctx.right, ctx.mesh, ctx.t
        gx = g[:, left:left + t].clone()
        n, s = mesh.sp, mesh.sp_index
        if n > 1:
            halos = torch.cat([g[:, :left], g[:, left + t:]],
                              dim=1).contiguous()
            parts = [torch.empty_like(halos) for _ in range(n)]
            dist.all_gather(parts, halos, group=mesh.sp_group)
            if s > 0:  # rank s − 1's right halo copied my first rows
                gx[:, :right] += parts[s - 1][:, left:]
            if s < n - 1:  # rank s + 1's left halo copied my last rows
                gx[:, t - left:] += parts[s + 1][:, :left]
        return gx, None, None, None


def _halo_rows(xf, vpad, mesh):
    """The flat kernels' operand: the block [B, T_loc, F·C] with one
    neighbour t-step a side, ``vpad`` [B, F·C] at the global boundary. One
    row is enough: the tile_t / 2 halo of the JAX package is a Mosaic tiling
    artefact."""
    return _halo(xf, 1, 1, mesh, pad=vpad)


def _zero_pad_row(scale, shift):
    """Per-channel input value v with scale·v + shift == 0 (ridge-regularised:
    degrades to v = 0 where scale ≈ 0, where the prologue's output is the
    constant ``shift`` for every row anyway, and exact when shift = 0 too)."""
    return -shift * scale / (scale * scale + 1e-30)


def _conv_same_sp(p, x, kernel_size: int, mesh):
    """Stride-1 SAME conv of an NHWC block: halo k // 2, VALID over T, SAME
    over F."""
    pad = kernel_size // 2
    return conv_apply(p, _halo(x, pad, pad, mesh), padding=(0, pad))


def _down_conv_sp(p, x, mesh):
    """k4 s2 p1 downsample of an NHWC block: halo (1, 2), VALID over T."""
    return conv_apply(p, _halo(x, 1, 2, mesh), stride=2, padding=(0, 1))


def _up_conv_sp(p, x, mesh):
    """Transposed k4 s2 p1 of an NHWC block: halo (1, 1), transpose-conv the
    haloed block, crop 2 output rows a side."""
    return conv_transpose_apply(p, _halo(x, 1, 1, mesh), stride=2,
                                padding=1)[:, 2:-2]


def _all_reduce(v, mesh):
    if mesh.sp > 1:
        dist.all_reduce(v, group=mesh.sp_group)
    return v


def _group_norm_sp(p, x, mesh, *, num_groups: int = GROUPS, eps: float = 1e-6):
    """GroupNorm of an NHWC block with the whole clip's statistics: the
    per-(sample, group) sums all-reduced over sp, in x's dtype as the JAX
    package sums them."""
    b, t, f, c = x.shape
    xg = x.reshape(b, t, f, num_groups, c // num_groups)
    sums = _all_reduce(torch.stack([xg.sum(dim=(1, 2, 4), keepdim=True),
                                    xg.square().sum(dim=(1, 2, 4),
                                                    keepdim=True)]), mesh)
    n = mesh.sp * t * f * (c // num_groups)
    mean = sums[0] / n
    var = sums[1] / n - mean.square()
    x = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, t, f, c)
    x = x * p["g"].to(x.dtype)
    if "b" in p:
        x = x + p["b"].to(x.dtype)
    return x


def _global_sums(xf, c: int, mesh):
    """Per-(sample, channel) (sum, sum²) of the whole clip from a block
    [B, T_loc, F·C]: ``channel_sums`` all-reduced over sp."""
    return tuple(_all_reduce(torch.stack(channel_sums(xf, c)), mesh).unbind(0))


def _resblock_sp(p, x, temb, *, kernel_size: int, mesh):
    """The plain residual block over an NHWC block (stages the flat kernels
    do not take)."""
    h = F.silu(_group_norm_sp(p["norm1"], x, mesh))
    h = (_conv_same_sp(p["conv1"], h, kernel_size, mesh)
         + temb[:, None, None, :].to(x.dtype))
    h = _group_norm_sp(p["norm2"], F.silu(h), mesh)
    h = F.silu(_conv_same_sp(p["conv2"], h, kernel_size, mesh))
    return x + _group_norm_sp(p["norm3"], h, mesh)


def _conv3x3_sp(xf, w, pre, mesh, *, c: int, **kw):
    """``conv3x3_flat`` with GroupNorm prologue ``pre`` on the block with one
    halo row a side, cropped back to the block."""
    t, fc = xf.shape[1], xf.shape[2]
    vpad = _zero_pad_row(*pre).repeat(1, fc // c)
    out = conv3x3_flat(_halo_rows(xf, vpad, mesh), w, c=c, pre=pre, **kw)
    return out[:, 1:t + 1]


def _resblock_rows_sp(p, xf, temb, in_sums, *, f: int, c: int, n: int, mesh,
                      tap_int8: bool, want_out_sums: bool):
    """One residual block on the flat kernels over a block [B, T_loc, F·C]
    (``ops.flat_resblock.resblock_flat`` with a halo around each conv and
    the GroupNorm sums of the whole clip). in_sums: the clip's per-channel
    (sum, sum²) of xf; n = T_global·F·C/G. Returns (out, its sums | None)."""
    dtype = xf.dtype
    w1, kw1 = conv3x3_taps(p["conv1"], dtype, tap_int8)
    w2, kw2 = conv3x3_taps(p["conv2"], dtype, tap_int8)
    h = _conv3x3_sp(xf, w1, gn_affine_from_sums(*in_sums, n, p["norm1"], c),
                    mesh, c=c, pre_silu=True, add=temb, post_silu=True, **kw1)
    s = _conv3x3_sp(h, w2, gn_affine_from_sums(*_global_sums(h, c, mesh), n,
                                               p["norm2"], c),
                    mesh, c=c, add=p["conv2"]["b"], post_silu=True, **kw2)
    scale3, shift3 = gn_affine_from_sums(*_global_sums(s, c, mesh), n,
                                         p["norm3"], c)
    out = resblock_tail(xf, s, scale3, shift3, f=f, c=c)
    return out, (_global_sums(out, c, mesh) if want_out_sums else None)


def _stage_blocks_sp_flat(stage, h, temb_iter, *, cfg: ModelConfig, mesh):
    """A stage's resblock chain on the flat kernels over an NHWC block, the
    clip's statistics threaded from block to block."""
    b, t_loc, f, c = h.shape
    xf = h.reshape(b, t_loc, f * c)
    n = t_loc * mesh.sp * f * (c // GROUPS)
    sums = _global_sums(xf, c, mesh)
    blocks = stage["blocks"]
    for k, block in enumerate(blocks):
        xf, sums = _resblock_rows_sp(
            block, xf, next(temb_iter), sums, f=f, c=c, n=n, mesh=mesh,
            tap_int8=tap_int8_stage(cfg, c),
            want_out_sums=k < len(blocks) - 1)
    return xf.reshape(b, t_loc, f, c)


def _flat_stage(cfg: ModelConfig, krn: int) -> bool:
    """Whether a stage's resblocks run the flat kernels: 3×3 convs, and not
    the plain (``conv_impl: xla``) reference route."""
    return krn == 3 and cfg.conv_impl != "xla"


def sp_eval_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config the sp forward runs: without int8 activation storage and
    with plain strided transitions."""
    return dataclasses.replace(cfg, act_store=None, strided_int8=False)


def check_sp_time(t_total: int, cfg: ModelConfig, sp: int) -> None:
    stride_total = 2 ** (len(cfg.ch) - 1)
    if t_total % (sp * stride_total) != 0:
        raise ValueError(f"T={t_total} must be divisible by sp×stride = "
                         f"{sp * stride_total}")


def apply_model_sp_local(params, x, t, cfg: ModelConfig, mesh):
    """The per-rank forward: x this rank's block [B_loc, C, T_loc, F], t its
    timesteps [B_loc] → its ε block [B_loc, C, T_loc, F] fp32. params: the
    tree from ``sp_sampling_bundle`` (conv weights cast, int8 taps
    quantised once)."""
    cfg = sp_eval_cfg(cfg)
    h = x.permute(0, 2, 3, 1).to(cfg.dtype)
    temb_iter = iter(_temb_chunks(params, t, cfg))

    def run_blocks(stage, krn, h):
        if _flat_stage(cfg, krn):
            return _stage_blocks_sp_flat(stage, h, temb_iter, cfg=cfg,
                                         mesh=mesh)
        for block in stage["blocks"]:
            h = _resblock_sp(block, h, next(temb_iter), kernel_size=krn,
                             mesh=mesh)
        return h

    h = _conv_same_sp(params["down_modules"]["head"], h, 3, mesh)
    hidden = [h]
    for stage, krn in zip(params["down_modules"]["stages"], cfg.krn):
        if "down" in stage:
            h = _down_conv_sp(stage["down"], h, mesh)
        h = run_blocks(stage, krn, h)
        hidden.append(h)

    # bottleneck: gather the (short) token axis, mix it whole, keep my slice
    tt = h.shape[1]
    full = all_gather_cat(h, mesh.sp_group, 1)
    h = _bottleneck(params, full, cfg)[:, mesh.sp_index * tt:
                                       (mesh.sp_index + 1) * tt]

    for stage, krn in zip(reversed(params["up_modules"]["stages"]),
                          reversed(cfg.krn)):
        h = run_blocks(stage, krn, h + hidden.pop())
        if "up" in stage:
            h = _up_conv_sp(stage["up"], h, mesh)
    h = _conv_same_sp(params["up_modules"]["tail"], h + hidden.pop(), 3, mesh)
    return h.permute(0, 3, 1, 2).float()


# ---------------------------------------------------------------- training

class _PsumKeepSp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, mesh):
        out = v.clone()
        dist.all_reduce(out, group=mesh.sp_group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_keep_sp(v, mesh):
    """v summed over the sp ranks; the backward passes the cotangent on as
    it is (each rank's gradients stay its partial sums)."""
    return _PsumKeepSp.apply(v, mesh) if mesh.sp > 1 else v


class _GatherTimeT(torch.autograd.Function):
    """The sp ranks' blocks of x [B, T_loc, …] concatenated along time; the
    backward all-reduces the whole cotangent (every rank ran the gathered
    tensor's consumer on its own loss) and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.t = mesh, x.shape[1]
        return all_gather_cat(x, mesh.sp_group, 1)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.mesh.sp_group)
        i = ctx.mesh.sp_index
        return g[:, i * ctx.t:(i + 1) * ctx.t], None


def _conv3x3_flat_sp_t(xf, w, add, *, c: int, mesh):
    """``conv3x3_flat_t`` over a time block: one halo row a side (zeros at
    the global boundary: the input is the post-GroupNorm/SiLU activation,
    which the conv zero-pads; the kernel's bare mode has no prologue), the
    kernels' forward, dx and dW on the T_loc + 2-row block, cropped."""
    t = xf.shape[1]
    return conv3x3_flat_t(_halo(xf, 1, 1, mesh), w, add, c=c)[:, 1:t + 1]


def _resblock_sp_t(p, x, temb, *, krn: int, flat: bool, mesh):
    """The differentiable resblock over an NHWC time block x [B, T_loc, F,
    C]: ``resblock_flat_train`` with the whole clip's GroupNorm statistics
    and, per conv, the flat kernels on the haloed block (``flat``) or a
    plain conv with a halo of krn // 2 rows and the add in fp32."""
    b, t, f, c = x.shape

    def conv(h, w, add):
        if flat:
            return _conv3x3_flat_sp_t(h, w, add, c=c, mesh=mesh)
        out = _conv_same_sp({"w": w}, h.view(b, t, f, c), krn, mesh)
        add = add if add.ndim == 2 else add[None]
        return (out.float() + add[:, None, None, :]).to(h.dtype).reshape(
            b, t, f * c)

    out = resblock_flat_train(p, x.reshape(b, t, f * c), temb, f=f, c=c,
                              conv=conv, sp_group=mesh.sp_group)
    return out.view(b, t, f, c)


def flat_train_flags(cfg: ModelConfig, t_total: int, sp: int):
    """Per stage, whether the sp training forward runs its resblock convs on
    the flat kernels: 3×3 convs, ``conv_impl`` not the plain route, and an
    even time block (as the JAX package gates it)."""
    return tuple(krn == 3 and cfg.conv_impl != "xla"
                 and (t_total // (sp << i)) % 2 == 0
                 for i, krn in enumerate(cfg.krn))


def sp_local_train_forward(params, x, t, generator, cfg: ModelConfig, flags,
                           mesh):
    """The per-rank training forward: x this rank's block [B_loc, C, T_loc,
    F], t its timesteps → its ε block [B_loc, C, T_loc, F] fp32,
    differentiable over the split time axis (module docstring). flags:
    ``flat_train_flags``. The bottleneck runs on the gathered tokens on
    every sp rank with ``generator``'s dropout, which every sp rank seeds
    alike. Parameter gradients are this rank's partial sums."""
    h = x.permute(0, 2, 3, 1).to(cfg.dtype)
    temb_iter = iter(_temb_chunks(params, t, cfg))

    def run_blocks(stage, krn, flat, h):
        block_fn = _remat(functools.partial(_resblock_sp_t, krn=krn,
                                            flat=flat, mesh=mesh), cfg)
        for block in stage["blocks"]:
            h = block_fn(block, h, next(temb_iter))
        return h

    h = _conv_same_sp(params["down_modules"]["head"], h, 3, mesh)
    hidden = [h]
    for stage, krn, flat in zip(params["down_modules"]["stages"], cfg.krn,
                                flags):
        if "down" in stage:
            h = _down_conv_sp(stage["down"], h, mesh)
        h = run_blocks(stage, krn, flat, h)
        hidden.append(h)

    tt = h.shape[1]
    full = _bottleneck(params, _GatherTimeT.apply(h, mesh), cfg, train=True,
                       generator=generator)
    h = full[:, mesh.sp_index * tt:(mesh.sp_index + 1) * tt]

    for stage, krn, flat in zip(reversed(params["up_modules"]["stages"]),
                                reversed(cfg.krn), reversed(flags)):
        h = run_blocks(stage, krn, flat, h + hidden.pop())
        if "up" in stage:
            h = _up_conv_sp(stage["up"], h, mesh)
    h = _conv_same_sp(params["up_modules"]["tail"], h + hidden.pop(), 3, mesh)
    return h.permute(0, 3, 1, 2).float()


def sp_sampling_bundle(params, cfg: ModelConfig, mesh, t_total: int):
    """The tree a sampler passes on every step, made once per weight set:
    ``prepare_params`` under ``sp_eval_cfg`` (conv weights cast to the
    compute dtype; the int8-tap stages' weights quantised from the fp32
    weights, also at the widths that int8 storage would take on one
    device). Logs that ``act_store`` is ignored where the config sets it."""
    check_sp_time(t_total, cfg, mesh.sp)
    if cfg.act_store:
        logging.getLogger(__name__).warning(
            "sampling.act_store=%s is ignored on sp>1 meshes (no int8 "
            "activation storage across halo exchanges); running %s "
            "activations", cfg.act_store, cfg.dtype)
    return prepare_params(params, sp_eval_cfg(cfg))


def apply_model_sp(params, x, t, cfg: ModelConfig, mesh, *, packed=None):
    """Sequence-parallel forward of a global x [B, C, T, F] (the same on
    every rank): each rank runs its time block (and its batch slice over dp
    on a dp × sp mesh when dp divides B) and the blocks are all-gathered, so
    every rank returns the global ε [B, C, T, F] fp32. T must divide into sp
    × the total stride. ``packed``: the tree from ``sp_sampling_bundle``
    (made here when absent). Training runs ``sp_local_train_forward``
    through the train step."""
    check_sp_time(x.shape[2], cfg, mesh.sp)
    if packed is None:
        packed = sp_sampling_bundle(params, cfg, mesh, x.shape[2])
    out = apply_model_sp_local(packed, shard_batch(mesh, x, time_axis=2),
                               shard_batch(mesh, t), cfg, mesh)
    return gather_batch(mesh, out, x.shape, time_axis=2)
