"""Fused residual block over the flat state [B, T, F·C] (port of
``ddim_audio_tpu/ops/flat_resblock.py::resblock_flat``, float or int8 taps).

    x → GN1 → SiLU → conv1 (+temb) → SiLU → GN2 → conv2 (+b) → SiLU → GN3 → +x

runs as two fused ``conv3x3_flat`` calls plus plain torch glue:

1. conv1 with GN1 as its prologue affine (from precomputed statistics) +
   SiLU, the per-sample temb add + SiLU in the epilogue, and GN2's
   statistics from the epilogue;
2. conv2 with GN2 as its prologue, bias + SiLU epilogue, GN3's statistics;
3. the tail ``x + GN3(s)`` (an XLA fusion in the JAX package, not a Pallas
   kernel) and the next block's statistics from the storage-dtype result, as
   the JAX package takes them, in one ``residual_affine_flat`` call.

GroupNorm statistics are per-(sample, channel) sums [B, C]; the groups fold
from them exactly (8 groups, eps 1e-6).

``resblock_flat_int8`` is the int8 activation-storage block (port of
``resblock_flat_int8``, ``sampling.act_store: int8``): both convs store their
outputs as int8 + per-group scales (``conv3x3_flat`` with ``quant_out``,
float taps), and the tail runs as the fused ``residual_affine_flat`` kernel.
"""

from __future__ import annotations

import torch

from .sums import batch_sums
from .conv_flat import conv3x3_flat, quantize_conv_weights_int8
from .residual_affine import residual_affine_flat

GROUPS = 8
EPS = 1e-6


def channel_sums(x_flat: torch.Tensor, c: int):
    """Per-(sample, channel) (sum, sum²) over T and F, accumulated in fp32
    from x's own values: ([B, C], [B, C]), each sample's sums in the same
    order at any batch size (``ops.sums``)."""
    b, t, fc = x_flat.shape
    s = batch_sums(x_flat.view(b, t * (fc // c), c), squares=True)
    return s[:, 0], s[:, 1]


def gn_affine_from_sums(s1, s2, n: int, norm_params, c: int):
    """GroupNorm folded to per-channel (scale, shift) [B, C] fp32 from
    per-channel sums (n = elements per (sample, group)): GN(x) = x·scale + shift."""
    b = s1.shape[0]
    cpg = c // GROUPS
    # [B, G, 1] group moments, broadcast back over the group's channels
    mean = s1.view(b, GROUPS, cpg).sum(dim=2, keepdim=True) / n
    var = s2.view(b, GROUPS, cpg).sum(dim=2, keepdim=True) / n - mean * mean
    rstd = torch.rsqrt(var.clamp_min(0.0) + EPS)
    scale = rstd * norm_params["g"].float().view(GROUPS, cpg)
    shift = -mean * scale
    if "b" in norm_params:
        shift = shift + norm_params["b"].float().view(GROUPS, cpg)
    return scale.view(b, c), shift.view(b, c)


def conv_taps(conv, dtype, int8: bool):
    """(w, w_scale) of a conv (a resblock's, or a transition's for
    ``conv_down_flat`` / ``conv_up_flat``): the float weight in the compute
    dtype, or the int8 weight and its scales from
    ``models.unet.prepare_params``'s copy (``wq``, ``w_scale``). A tree that
    was not prepared is quantised here only while it still holds the fp32
    weights, which gives the same integers; quantising a weight that was
    already cast would not, so that raises."""
    if not int8:
        return conv["w"].to(dtype), None
    if "wq" in conv:
        return conv["wq"], conv["w_scale"]
    if conv["w"].dtype != torch.float32:
        raise ValueError(
            f"int8 taps: the conv weight is {conv['w'].dtype} and has no "
            "'wq'/'w_scale': int8 weights are quantised from the fp32 "
            "weights (models.unet.prepare_params), not from a cast copy")
    return quantize_conv_weights_int8(conv["w"])


def conv3x3_taps(conv, dtype, int8: bool):
    """``conv_taps`` of a resblock conv as ``conv3x3_flat`` takes it, or of a
    transition as ``conv_down_flat`` / ``conv_up_flat`` do: (w, {"w_scale":
    …, "wq_t": …}),
    wq_t the int8 kernel's [kh, kw, C_out, C_in] copy of the int8 weights
    where ``prepare_params`` made one (else the wrapper makes it per
    call)."""
    w, w_scale = conv_taps(conv, dtype, int8)
    wq_t = conv.get("wq_t") if w_scale is not None and "wq" in conv else None
    return w, {"w_scale": w_scale, "wq_t": wq_t}


def resblock_tail(x_flat, s, scale3, shift3, *, f: int, c: int,
                  want_stats: bool = False):
    """The float block's tail ``x + GN3(s)`` = ``x + s·scale3 + shift3``
    (x, s [B, T, f·c]; scale3, shift3 [B, C] fp32), in fp32 and
    in the JAX package's order: ``s·scale3`` is added to x first as one
    product-sum (as XLA fuses it), then shift3, rounded once to x's dtype.
    want_stats appends the output's per-channel (sum, sum²) [B, C], taken on
    the values as stored.

    One ``residual_affine_flat`` call: the kernel on a CUDA tensor, which
    needs C % 32 == 0 (every width of configs/audio.yml) and raises at any
    other width; the twin's torch passes on a CPU tensor."""
    # the kernel walks contiguous rows; the sp shards pass cropped views
    return residual_affine_flat(
        x_flat.contiguous(), s.contiguous(), (scale3, shift3), c=c,
        want_stats=want_stats, out_dtype=x_flat.dtype)


def resblock_flat(p, x_flat, temb, *, f: int, c: int, in_stats=None,
                  want_out_stats: bool = False, tap_int8: bool = False):
    """p: resblock params; x_flat [B, T, F·C] in the compute dtype; temb
    [B, C] fp32. in_stats: optional per-channel (sum, sum²) of x_flat from
    the producer (previous block or a transition kernel); computed here when
    absent. tap_int8: both convs run their taps in int8
    (``conv3x3_flat_int8``); the tail ``x + GN3(s)`` is unchanged. Returns
    out, or (out, out_stats) when want_out_stats."""
    dtype = x_flat.dtype
    b, t, fc = x_flat.shape
    n = t * f * (c // GROUPS)
    if in_stats is None:
        in_stats = channel_sums(x_flat, c)
    w1, kw1 = conv3x3_taps(p["conv1"], dtype, tap_int8)
    w2, kw2 = conv3x3_taps(p["conv2"], dtype, tap_int8)
    h, h1, h2 = conv3x3_flat(
        x_flat, w1, c=c, pre=gn_affine_from_sums(*in_stats, n, p["norm1"], c),
        pre_silu=True, add=temb, post_silu=True, want_stats=True, **kw1)
    s, s1, s2 = conv3x3_flat(
        h, w2, c=c, pre=gn_affine_from_sums(h1, h2, n, p["norm2"], c),
        add=p["conv2"]["b"], post_silu=True, want_stats=True, **kw2)
    scale3, shift3 = gn_affine_from_sums(s1, s2, n, p["norm3"], c)
    res = resblock_tail(x_flat, s, scale3, shift3, f=f, c=c,
                        want_stats=want_out_stats)
    if want_out_stats:
        return res[0], res[1:]
    return res


def resblock_flat_int8(p, x_flat, temb, *, f: int, c: int, dtype,
                       in_stats=None, in_scales=None, quant_out: bool = False,
                       want_out_stats: bool = False):
    """The residual block with int8 activation storage. x_flat [B, T, F·C]
    is int8 with in_scales (an interior block) or float (a stage entry, from
    a transition kernel); dtype is the compute dtype, in which the convs
    stage their inputs and run float taps (``tap_int8`` does not apply
    here, as in the JAX package). in_stats: the per-channel (sum, sum²) of
    x's fp32 values before their quantisation; required for an int8 x.

    conv1 (GN1 from in_stats, SiLU, + temb, SiLU) and conv2 (GN2 from conv1's
    pre-quant statistics, + bias, SiLU) each emit int8 + scales; the tail
    ``deq(x) + deq(s)·scale3 + shift3`` (GN3 from conv2's pre-quant
    statistics) is quantised for the next block with ``quant_out`` and else
    emitted in dtype; ``want_out_stats`` adds its pre-quant statistics.
    Returns (out, out_scales | None, out_stats | None)."""
    b, t, fc = x_flat.shape
    n = t * f * (c // GROUPS)
    if x_flat.dtype != torch.int8:
        x_flat = x_flat.to(dtype)
    if in_stats is None:
        if x_flat.dtype == torch.int8:
            raise ValueError("an int8 input needs in_stats (its pre-quant "
                             "sums)")
        in_stats = channel_sums(x_flat, c)
    w1, _ = conv_taps(p["conv1"], dtype, False)
    w2, _ = conv_taps(p["conv2"], dtype, False)
    h, h_sc, h1, h2 = conv3x3_flat(
        x_flat, w1, c=c, in_scales=in_scales,
        pre=gn_affine_from_sums(*in_stats, n, p["norm1"], c), pre_silu=True,
        add=temb, post_silu=True, want_stats=True, quant_out=True)
    s, s_sc, s1, s2 = conv3x3_flat(
        h, w2, c=c, in_scales=h_sc,
        pre=gn_affine_from_sums(h1, h2, n, p["norm2"], c),
        add=p["conv2"]["b"], post_silu=True, want_stats=True, quant_out=True)
    res = residual_affine_flat(
        x_flat, s, gn_affine_from_sums(s1, s2, n, p["norm3"], c), c=c,
        x_scales=in_scales, s_scales=s_sc, quant_out=quant_out,
        want_stats=want_out_stats, out_dtype=dtype)
    res = res if isinstance(res, tuple) else (res,)
    return (res[0], res[1] if quant_out else None,
            tuple(res[-2:]) if want_out_stats else None)
